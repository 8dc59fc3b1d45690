"""Artifact stores (the port's copy of ``repro.core.artifacts``):
directory-backed PersistentVolume (the paper stages datasets in PVCs) and
S3Store (the paper copies every trained model to S3 after training "to
ensure their later availability for evaluation")."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional


class PersistentVolume:
    """A named mount with quota accounting, like a Nautilus PVC."""

    def __init__(self, root: str, name: str = "repro-data",
                 quota_gb: Optional[float] = None):
        self.name = name
        self.root = (Path(root) / name).resolve()
        self.root.mkdir(parents=True, exist_ok=True)
        self.quota_gb = quota_gb

    def path(self, rel: str) -> Path:
        p = (self.root / rel).resolve()
        if not str(p).startswith(str(self.root.resolve())):
            raise ValueError(f"path escapes volume: {rel}")
        return p

    def stage_bytes(self, rel: str, data: bytes) -> Path:
        self._check_quota(len(data))
        p = self.path(rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        return p

    def stage_json(self, rel: str, obj: Any) -> Path:
        return self.stage_bytes(rel, json.dumps(obj, indent=1,
                                                default=str).encode())

    def read_bytes(self, rel: str) -> bytes:
        return self.path(rel).read_bytes()

    def exists(self, rel: str) -> bool:
        return self.path(rel).exists()

    def usage_bytes(self) -> int:
        return sum(f.stat().st_size for f in self.root.rglob("*")
                   if f.is_file())

    def _check_quota(self, incoming: int):
        if self.quota_gb is not None:
            if (self.usage_bytes() + incoming) > self.quota_gb * 1e9:
                raise IOError(f"PVC {self.name} quota exceeded "
                              f"({self.quota_gb} GB)")

    def listdir(self, rel: str = ".") -> List[str]:
        base = self.path(rel)
        return sorted(str(p.relative_to(self.root))
                      for p in base.rglob("*") if p.is_file())


class S3Store:
    """S3-shaped object store backed by a directory: put/get/list with
    ETag-style content hashes."""

    def __init__(self, root: str, bucket: str = "repro-models"):
        self.bucket = bucket
        self.root = (Path(root) / bucket).resolve()
        self.root.mkdir(parents=True, exist_ok=True)

    def _key_path(self, key: str) -> Path:
        p = (self.root / key.lstrip("/")).resolve()
        if not str(p).startswith(str(self.root.resolve())):
            raise ValueError(f"bad key {key}")
        return p

    def put_bytes(self, key: str, data: bytes) -> str:
        p = self._key_path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        return hashlib.md5(data).hexdigest()

    def put_file(self, key: str, local: os.PathLike) -> str:
        p = self._key_path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(local, p)
        return hashlib.md5(Path(local).read_bytes()).hexdigest()

    def get_bytes(self, key: str) -> bytes:
        return self._key_path(key).read_bytes()

    def exists(self, key: str) -> bool:
        return self._key_path(key).exists()

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for p in self.root.rglob("*"):
            if p.is_file():
                k = str(p.relative_to(self.root))
                if k.startswith(prefix):
                    out.append(k)
        return sorted(out)

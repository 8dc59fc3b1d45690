"""Checkpointing: parameter/optimizer trees -> sharded ``.npz`` files with
a JSON manifest (port of ``repro.checkpoint.io``, same on-disk format).

Leaves are flattened to ``"/"``-joined path keys, stored in the shards with
``"|"`` in place of ``"/"``; files are split so no shard exceeds
``shard_bytes``, and ``manifest.json`` is written last.  A
:class:`~repro_torch.train.TrainState` flattens as the reference's does:
``params/...``, ``opt_state/m/...``, ``opt_state/v/...`` and ``step``
(int32), with the per-layer list stacked into ``periods/slot{j}/...`` (see
:mod:`repro_torch.convert`).  So a checkpoint written by either package
restores in the other.  A bf16 leaf is stored as its two raw bytes (numpy
``V2``) and named ``bfloat16`` in the manifest, as the reference stores it;
no ``ml_dtypes`` is needed on either side.

A checkpoint directory is *valid* iff ``manifest.json`` parses and every
shard it references loads with every declared key.  Anything else raises
:class:`CheckpointError`, so the manager can fall back to an older one.
``export_to_s3`` copies a checkpoint directory into an
:class:`~repro_torch.core.artifacts.S3Store` after training, as the paper
copies every trained model to S3.
"""
from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.convert import (BF16_NUMPY, _to_numpy, _to_torch,
                                 params_to_flat, slot_prefix)
from repro_torch.core.artifacts import S3Store

MANIFEST = "manifest.json"


class CheckpointError(RuntimeError):
    """A checkpoint directory is unreadable (missing/truncated manifest,
    torn shard).  Distinct from shape/key mismatches against ``like=``,
    which stay ``ValueError``/``KeyError``: those mean the checkpoint is
    intact but wrong for the requested restore."""


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def _flatten(tree, prefix: str = "", period: int = 1
             ) -> Dict[str, np.ndarray]:
    """Flatten a state tree to host arrays under path keys.  Tensors are
    copied to the host; a params tree (a dict with ``"layers"``) goes
    through :func:`repro_torch.convert.params_to_flat` with ``period``
    (the config's ``period_len``); a Python int (the step) becomes an
    int32 scalar as in the reference."""
    flat: Dict[str, np.ndarray] = {}
    if hasattr(tree, "_fields"):                      # TrainState
        for name in tree._fields:
            flat.update(_flatten(getattr(tree, name), _join(prefix, name),
                                 period))
    elif isinstance(tree, dict) and "layers" in tree:
        for key, arr in params_to_flat(tree, period).items():
            flat[_join(prefix, key)] = arr
    elif isinstance(tree, dict):
        for key, val in tree.items():
            flat.update(_flatten(val, _join(prefix, key), period))
    elif isinstance(tree, (list, tuple)):
        if tree:
            raise TypeError(f"{prefix}: only the params' 'layers' may be "
                            f"a list")
    elif isinstance(tree, torch.Tensor):
        flat[prefix] = _to_numpy(tree)
    elif isinstance(tree, int):
        flat[prefix] = np.asarray(tree, np.int32)
    else:
        flat[prefix] = np.asarray(tree)
    return flat


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_NUMPY else str(arr.dtype)


def save_checkpoint(directory, tree, step: int = 0,
                    shard_bytes: int = 1 << 30,
                    metadata: Optional[dict] = None,
                    fsync: bool = False, period: int = 1) -> str:
    """Write ``tree`` into ``directory``.  Shards first, manifest last, so
    a torn write is detectable (manifest missing => invalid).  With
    ``fsync=True`` the shards, the manifest and the directory entry are
    fsynced, as the atomic manager path needs before its rename.
    ``period`` is the layers' (see :func:`_flatten`)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree, period=period)
    shards, cur, cur_bytes = [], {}, 0
    for k in sorted(flat):
        arr = flat[k]
        if cur and cur_bytes + arr.nbytes > shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = arr
        cur_bytes += arr.nbytes
    if cur:
        shards.append(cur)

    manifest = {"step": step, "n_shards": len(shards),
                "keys": {}, "metadata": metadata or {}}
    for i, shard in enumerate(shards):
        fname = f"shard_{i:04d}.npz"
        np.savez(d / fname, **{k.replace("/", "|"): v
                               for k, v in shard.items()})
        if fsync:                       # shards durable *before* manifest
            fd = os.open(d / fname, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        for k, v in shard.items():
            manifest["keys"][k] = {"shard": fname, "shape": list(v.shape),
                                   "dtype": _dtype_name(v)}
    mpath = d / MANIFEST
    with open(mpath, "w") as f:
        f.write(json.dumps(manifest, indent=1))
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if fsync:
        dirfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
    return str(d)


def read_manifest(directory) -> dict:
    """Parse ``manifest.json`` or raise :class:`CheckpointError` with an
    actionable message (missing vs truncated/corrupt)."""
    mpath = Path(directory) / MANIFEST
    if not mpath.exists():
        raise CheckpointError(
            f"no {MANIFEST} in {directory} — checkpoint incomplete "
            f"(torn write or wrong directory)")
    try:
        manifest = json.loads(mpath.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"{mpath} is truncated or corrupt: {e}") from e
    if not isinstance(manifest, dict) or "keys" not in manifest:
        raise CheckpointError(f"{mpath} has no 'keys' table — not a "
                              f"checkpoint manifest")
    return manifest


def _restore(like, flat, key: str, P: int, row=None, n_rows=None):
    """The tree of ``like``'s structure filled from ``flat``: each tensor
    leaf shape-checked and cast to the ``like`` leaf's dtype and device.
    Layer ``p*P + j`` reads row p of ``periods/slot{j}/...``."""
    if hasattr(like, "_fields"):
        return type(like)(*(_restore(getattr(like, f), flat, _join(key, f),
                                     P, row, n_rows)
                            for f in like._fields))
    if isinstance(like, dict):
        out = {}
        for k, v in like.items():
            if k == "layers":
                out[k] = [_restore(l, flat,
                                   _join(key, slot_prefix(i % P)[:-1]), P,
                                   i // P, len(v) // P)
                          for i, l in enumerate(v)]
            else:
                out[k] = _restore(v, flat, _join(key, k), P, row, n_rows)
        return out
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    arr = flat[key]
    if row is not None:
        if arr.shape[:1] != (n_rows,):
            raise ValueError(f"{key}: leading axis {arr.shape[:1]} != "
                             f"n_periods {n_rows}")
        arr = arr[row]
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        # a dtype-only mismatch is cast, not refused
        return _to_torch(arr, like.device, like.dtype)
    return type(like)(arr)


def load_checkpoint(directory, like=None, period: int = 1):
    """Returns ``(tree_or_flat_dict, step)``.  With ``like`` (a
    ``TrainState`` or params tree), leaves are restored into that structure
    on its devices, shape-checked; dtype-only mismatches are cast to the
    ``like`` leaf's dtype.  ``period`` is the layers' (see
    :func:`_flatten`)."""
    d = Path(directory)
    manifest = read_manifest(d)
    flat: Dict[str, np.ndarray] = {}
    by_shard: Dict[str, list] = {}
    for k, info in manifest["keys"].items():
        by_shard.setdefault(info["shard"], []).append(k)
    for fname, keys in by_shard.items():
        try:
            with np.load(d / fname) as z:
                for k in keys:
                    flat[k] = z[k.replace("/", "|")]
        except (FileNotFoundError, zipfile.BadZipFile, OSError, EOFError,
                KeyError, ValueError) as e:
            raise CheckpointError(
                f"shard {fname} in {directory} is missing or torn "
                f"({type(e).__name__}: {e}); manifest declares "
                f"{len(keys)} keys in it") from e
    if like is None:
        return flat, manifest["step"]
    return _restore(like, flat, "", period), manifest["step"]


def export_to_s3(directory: str, s3: S3Store, prefix: str) -> int:
    """Paper: 'all models are copied to S3 cloud storage following
    training'.  Recurses so the manager's ``step_*/`` layout exports with
    its structure intact; hidden entries (``.tmp-*`` in-flight writes,
    ``.old-*`` aside copies) are never uploaded.  Returns number of
    objects uploaded."""
    root = Path(directory)
    n = 0
    for f in sorted(root.rglob("*")):
        rel = f.relative_to(root)
        if f.is_file() and not any(part.startswith(".")
                                   for part in rel.parts):
            s3.put_file(f"{prefix}/{rel.as_posix()}", f)
            n += 1
    return n

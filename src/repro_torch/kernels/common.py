"""Shared runtime helpers for the kernel subpackages: backend and device
resolution, and the nvcc build of the hand-written CUDA kernels.

Kernels are built at first use, never at import: this module imports
without ``nvcc`` or a card, so the CPU tests can import every module.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

BACKENDS = ("torch", "cuda", "auto")

# compiled libraries land here (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """Resolve a kernel-backend knob for tensor ``x``.

    ``"torch"`` and ``"cuda"`` are explicit.  ``"auto"`` picks the
    hand-written CUDA kernel for a CUDA tensor and the plain PyTorch
    version for a CPU tensor.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"known: {BACKENDS}")
    if backend == "auto":
        return "cuda" if x.is_cuda else "torch"
    return backend


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one given, else ``cuda``.
    Without a card and without an explicit device this raises — entry
    points never fall back to the CPU on their own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def _included(source: Path, seen: set) -> None:
    """Add ``source`` and every file it includes with ``#include "..."``
    (resolved beside the including file, recursively) to ``seen``."""
    source = source.resolve()
    if source in seen:
        return
    seen.add(source)
    for line in source.read_text().splitlines():
        m = re.match(r'\s*#\s*include\s*"([^"]+)"', line)
        if m:
            _included(source.parent / m.group(1), seen)


def library_key(source: Path) -> str:
    """The build key of ``source``: a hash of its text, of every header it
    includes (a changed header rebuilds the library) and of the flags."""
    seen: set = set()
    _included(Path(source), seen)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(seen):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return digest.hexdigest()[:16]


def build_library(source: Path) -> Path:
    """Compile one ``.cu`` source into a shared library under
    :data:`BUILD_DIR`, keyed by :func:`library_key` (its text, the headers
    it includes and the flags), and return its path.  A library already
    built from the same text is reused.
    The compile writes to a temporary name and is renamed into place, so
    concurrent builders never load a half-written file.  A failed build
    raises ``RuntimeError`` with the compiler's output."""
    source = Path(source)
    out = BUILD_DIR / f"{source.stem}-{library_key(source)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{source.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_libraries(sources) -> list:
    """Build several sources at once, one nvcc process each, all started
    together; returns the library paths in order."""
    sources = list(sources)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(build_library, sources))


def load_library(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load a kernel library with ``ctypes``."""
    return ctypes.CDLL(str(build_library(source)))

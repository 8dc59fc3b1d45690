"""ctypes binding of the hand-written CUDA percentile stretch (K5),
``csrc/percentile_norm.cu``, the Hopper counterpart of the Pallas TPU
kernel ``repro.kernels.percentile_norm.kernel._norm_kernel``.

The library is compiled with nvcc for ``sm_90a`` at first use (see
:func:`repro_torch.kernels.common.build_library`).  The wrapper checks its
inputs, allocates the output, launches on PyTorch's current stream without
synchronising, and raises if the launch reports a CUDA error.  It counts
its launches in ``percentile_norm_kernel.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.common import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "percentile_norm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's widest band count (csrc/percentile_norm.cu: MAX_BANDS)
MAX_BANDS = 4096
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.percentile_norm.argtypes = [p, p, p, p, i, i64, i, i64, p]
        lib.percentile_norm.restype = i
        lib.percentile_norm_error_string.argtypes = [i]
        lib.percentile_norm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, lo, hi):
    if x.dim() != 2 or x.shape[0] < 1 or not 1 <= x.shape[1] <= MAX_BANDS:
        raise ValueError(f"want x (R, C) with R >= 1 and 1 <= C <= "
                         f"{MAX_BANDS}; got {tuple(x.shape)}")
    C = x.shape[1]
    for name, t in (("lo", lo), ("hi", hi)):
        if t.shape != (1, C):
            raise ValueError(f"{name} must be (1, {C}); got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    for name, t in (("x", x), ("lo", lo), ("hi", hi)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
    if C > 1 and x.stride(1) != 1:
        raise ValueError(f"x: the bands must be contiguous; got strides "
                         f"{x.stride()}")
    if x.shape[0] > 1 and x.stride(0) < C:
        raise ValueError(f"x: rows must not overlap; got strides "
                         f"{x.stride()}")


def percentile_norm_kernel(x: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor) -> torch.Tensor:
    """K5.  x: (R, C) f32 or bf16, pixels by bands, the bands contiguous
    (rows may be further apart); lo/hi: (1, C) f32; all CUDA.  Returns the
    contiguous (R, C) f32 ``clip((x - lo) * (1 / max(hi - lo, 1e-12)), 0,
    1)``.  Each call that launches the kernel adds one to
    ``percentile_norm_kernel.launches``.
    """
    _check(x, lo, hi)
    R, C = x.shape
    lib = library()
    out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    ldx = x.stride(0) if R > 1 else C
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.percentile_norm(x.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                                   out.data_ptr(), _DTYPES[x.dtype], R, C,
                                   ldx, stream)
    if code != 0:
        raise RuntimeError(
            f"percentile_norm launch failed: CUDA error {code} "
            f"({lib.percentile_norm_error_string(code).decode()})")
    percentile_norm_kernel.launches += 1
    return out


percentile_norm_kernel.launches = 0

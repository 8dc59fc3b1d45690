"""ctypes binding of the hand-written CUDA SSD chunk scan (K4),
``csrc/ssd_scan.cu``, the Hopper counterpart of the Pallas TPU kernel
``repro.kernels.ssd_scan.kernel._ssd_kernel``.

The library is compiled with nvcc for ``sm_90a`` at first use (see
:func:`repro_torch.kernels.common.build_library`).  The wrapper checks its
inputs, allocates y and the final state, launches on PyTorch's current
stream without synchronising, and raises if the launch reports a CUDA
error.  It counts its launches in ``ssd_scan_kernel.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.common import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's limits (csrc/ssd_scan.cu: NMAX, QMAX, 16 <= hp <= 128)
MAX_STATE, MAX_CHUNK, MAX_HEAD_DIM = 128, 1024, 128
# dynamic shared memory a block may use on Hopper
MAX_SMEM = 232_448
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan.argtypes = [p] * 7 + [i] * 8 + [p, p]
        lib.ssd_scan.restype = i
        lib.ssd_scan_error_string.argtypes = [i]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(hp: int, N: int, Q: int) -> int:
    """Shared memory of one block, as ``ssd_scan.cu::smem_bytes``: the state
    (hp x N'), C and B tiles (64 x N'), an x tile (64 x hp), the 64 x 65
    decay tile and two chunk-long vectors, N' = N rounded up to 16, plus
    one, all f32."""
    nw = -(-N // 16) * 16
    return 4 * (hp * (nw + 1) + 2 * 64 * (nw + 1) + 64 * hp + 64 * 65 + 2 * Q)


def _check(x, dt, A, B, C, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or C.shape != B.shape:
        raise ValueError(f"want x (Bs,S,nh,hp), dt (Bs,S,nh), A (nh,), "
                         f"B/C (Bs,S,g,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    Bs, S, nh, hp = x.shape
    g, N = B.shape[2], B.shape[3]
    if (dt.shape != (Bs, S, nh) or A.shape != (nh,)
            or B.shape[:2] != (Bs, S) or nh % g):
        raise ValueError(f"mismatched shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(B.shape)}; nh must be a multiple of g")
    if hp % 16 or not 16 <= hp <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hp}: the kernel takes multiples of 16 "
                         f"up to {MAX_HEAD_DIM}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"d_state {N}: the kernel takes 1..{MAX_STATE}")
    Q = min(chunk, S)
    if S < 1 or not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"S={S} and chunk={chunk}: need S >= 1 and "
                         f"1 <= min(chunk, S) <= {MAX_CHUNK}")
    if smem_bytes(hp, N, Q) > MAX_SMEM:
        raise ValueError(f"hp={hp}, N={N}, Q={Q} needs "
                         f"{smem_bytes(hp, N, Q)} bytes of shared memory; "
                         f"a block has {MAX_SMEM}")
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x/B/C must share one dtype of float32 or "
                        f"bfloat16; got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous; got "
                             f"strides {t.stride()}")
    if A.stride(0) != 1:
        raise ValueError("A must be contiguous")


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """K4.  x: (Bs, S, nh, hp) f32 or bf16; dt: (Bs, S, nh) f32; A: (nh,)
    f32; B/C: (Bs, S, g, N) in x's dtype, head h reading group
    ``h // (nh // g)``; all CUDA, read through their strides (the last dim
    contiguous).  The chunk is ``min(chunk, S)``.

    Returns ``(y (Bs, S, nh, hp) in x's dtype, h_final (Bs, nh, hp, N)
    f32)``.  Each call that launches the kernel adds one to
    ``ssd_scan_kernel.launches``.
    """
    _check(x, dt, A, B, C, chunk)
    Bs, S, nh, hp = x.shape
    g, N = B.shape[2], B.shape[3]
    lib = library()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h = torch.empty((Bs, nh, hp, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 12)(*x.stride()[:3], *dt.stride(),
                                    *B.stride()[:3], *C.stride()[:3])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), _DTYPES[x.dtype], Bs,
            S, nh, hp, g, N, min(chunk, S),
            ctypes.cast(strides, ctypes.c_void_p), stream)
    if code != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {code} "
                           f"({lib.ssd_scan_error_string(code).decode()})")
    ssd_scan_kernel.launches += 1
    return y, h


ssd_scan_kernel.launches = 0

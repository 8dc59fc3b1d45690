"""ctypes binding of the hand-written CUDA SSD chunk scan (K4),
``csrc/ssd_scan.cu``, the Hopper counterpart of the Pallas TPU kernel
``repro.kernels.ssd_scan.kernel._ssd_kernel``.

Each call takes one of two routes by :func:`route`: ``"tensor_core"``
(``wgmma`` fed by TMA, the Hopper building blocks of
``flash_attention/csrc/hopper.cuh``) for bf16 at head dims 64 and 128 with a
state width N that is a multiple of 16 up to 128, ``"cuda_core"`` (f32
FMAs) for the rest.

The library is compiled with nvcc for ``sm_90a`` at first use (see
:func:`repro_torch.kernels.common.build_library`).  The wrapper checks its
inputs, allocates y and the final state, launches on PyTorch's current
stream without synchronising, and raises if the launch reports a CUDA
error.  It counts its launches in ``ssd_scan_kernel.launches`` and by route
in ``ssd_scan_kernel.launches_by_route``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.common import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (dtype, head_dim) pairs the kernel runs on the tensor cores when the state
# width N is a multiple of 16 (up to MAX_STATE); every other input it takes
# runs on the CUDA cores.  f32 stays off the tensor cores: h_final is held
# to an f32 tolerance.  The same table is route_of in ssd_scan.cu (a test
# holds the two together).
TENSOR_CORE = frozenset({(torch.bfloat16, 64), (torch.bfloat16, 128)})
ROUTES = ("tensor_core", "cuda_core")
# the kernel's limits (csrc/ssd_scan.cu: NMAX, QMAX, 16 <= hp <= 128)
MAX_STATE, MAX_CHUNK, MAX_HEAD_DIM = 128, 1024, 128
# dynamic shared memory a block may use on Hopper
MAX_SMEM = 232_448
_lib: Optional[ctypes.CDLL] = None


def route(dtype: torch.dtype, hp: int, N: int) -> str:
    """K4's route for x/B/C of ``dtype``, head dim ``hp`` and state width
    ``N``: ``"tensor_core"`` or ``"cuda_core"``."""
    tc = (dtype, hp) in TENSOR_CORE and N % 16 == 0 and 16 <= N <= MAX_STATE
    return ROUTES[0] if tc else ROUTES[1]


def library() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan.argtypes = [p] * 7 + [i] * 8 + [p, p]
        lib.ssd_scan.restype = i
        lib.ssd_scan_route.argtypes = [i, i, i]
        lib.ssd_scan_route.restype = i
        lib.ssd_scan_error_string.argtypes = [i]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(hp: int, N: int, Q: int, route_: str = ROUTES[1]) -> int:
    """Shared memory of one block, as ``ssd_scan.cu`` allocates it on each
    route.  CUDA cores (``smem_bytes``): the state (hp x N'), C and B tiles
    (64 x N'), an x tile (64 x hp), the 64 x 65 decay tile and two
    chunk-long vectors, N' = N rounded up to 16, plus one, all f32.  Tensor
    cores (``tc::Layout::alloc``, the same for every hp and N, since a
    block owns one 64-column slab of a head and N <= 128): a 3-stage ring of
    B and x column tiles (three 8 KB boxes a stage), four C row tiles of
    two boxes, h^T's bf16 hi and lo parts (128 rows of 128 bytes each), the
    f32 h^T (128 x 64), la, dt and the state update's weights of two chunks
    (Q rounded up to 64), 18 mbarriers and 1 KB to align the base to 1024
    bytes."""
    if route_ == ROUTES[0]:
        box = 64 * 128
        qr = -(-Q // 64) * 64
        return (3 * 3 * box + 4 * 2 * box + 2 * 128 * 128 + 128 * 64 * 4
                + 2 * 3 * qr * 4 + 8 * 18 + 1024)
    nw = -(-N // 16) * 16
    return 4 * (hp * (nw + 1) + 2 * 64 * (nw + 1) + 64 * hp + 64 * 65 + 2 * Q)


def tma_misaligned(t: torch.Tensor) -> bool:
    """Whether TMA cannot read ``t`` (x, B or C, 4-D with a contiguous last
    dim) on the tensor-core route: its base must be 16-byte aligned, and
    the strides of its first three dims whole 16 bytes wherever the dim is
    longer than 1 (``make_map`` gives a dim of size 1 the packed
    stride)."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 != 0 or any(
        n > 1 and s % step for n, s in zip(t.shape[:3], t.stride()[:3]))


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
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x/B/C must share one dtype of float32 or "
                        f"bfloat16; got {x.dtype}, {B.dtype}, {C.dtype}")
    path = route(x.dtype, hp, N)
    if smem_bytes(hp, N, Q, path) > MAX_SMEM:
        raise ValueError(f"hp={hp}, N={N}, Q={Q} needs "
                         f"{smem_bytes(hp, N, Q, path)} bytes of shared "
                         f"memory; a block has {MAX_SMEM}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous; got "
                             f"strides {t.stride()}")
        if path == ROUTES[0] and tma_misaligned(t):
            raise ValueError(f"{name}: the tensor-core route reads it by "
                             f"TMA, which needs a 16-byte aligned base and "
                             f"16-byte strides; got strides {t.stride()}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
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
    ``ssd_scan_kernel.launches`` and to its route's entry in
    ``.launches_by_route``.
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
    ssd_scan_kernel.launches_by_route[route(x.dtype, hp, N)] += 1
    return y, h


ssd_scan_kernel.launches = 0
ssd_scan_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)

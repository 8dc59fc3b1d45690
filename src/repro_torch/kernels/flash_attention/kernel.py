"""ctypes bindings of the hand-written CUDA flash-attention kernels, the
Hopper counterparts of the Pallas TPU kernels in
``repro.kernels.flash_attention.kernel``:

* ``csrc/flash_fwd.cu`` — the forward (``_attn_fwd_kernel``, K1);
* ``csrc/flash_bwd.cu`` — the backward, dQ (``_attn_bwd_dq_kernel``, K2)
  and dK/dV (``_attn_bwd_dkv_kernel``, K3).

Each kernel takes one of two routes by :func:`route`: ``"tensor_core"``
(wgmma, TMA; the Hopper building blocks in ``csrc/hopper.cuh``) for bf16
at head dims 64 and 128, ``"cuda_core"`` (f32 FMAs) for the rest.

Each library is compiled with nvcc for ``sm_90a`` at first use (see
:func:`repro_torch.kernels.common.build_library`).  A wrapper checks its
inputs, allocates the outputs, launches on PyTorch's current stream without
synchronising, and raises if the launch reports a CUDA error.  Each wrapper
counts its own launches in ``.launches`` and by route in
``.launches_by_route``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.common import load_library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_fwd.cu"
BWD_SOURCE = CSRC / "flash_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (dtype, head_dim) pairs the kernels run on the tensor cores; every other
# pair they take runs on the CUDA cores.  f32 stays off the tensor cores:
# TF32 would break the f32 tolerances the reduced configs rely on.  The
# same table is route_of in flash_fwd.cu and in flash_bwd.cu (tests hold
# the three together).
TENSOR_CORE = frozenset({(torch.bfloat16, 64), (torch.bfloat16, 128)})
ROUTES = ("tensor_core", "cuda_core")
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of K1, K2 and K3 for q/k/v of ``dtype`` and ``head_dim``:
    ``"tensor_core"`` or ``"cuda_core"``."""
    return ROUTES[0] if (dtype, head_dim) in TENSOR_CORE else ROUTES[1]


def library() -> ctypes.CDLL:
    """Build (once per process) and load the forward kernel library."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p, i,
                                  i, ctypes.c_float, p]
        lib.flash_fwd.restype = i
        lib.flash_fwd_route.argtypes = [i, i]
        lib.flash_fwd_route.restype = i
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def bwd_library() -> ctypes.CDLL:
    """Build (once per process) and load the backward kernel library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = load_library(BWD_SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_bwd_dq.argtypes = [p] * 7 + [i] * 7 + [p, i, i, f, p]
        lib.flash_bwd_dq.restype = i
        lib.flash_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + [p, i, i, f, p]
        lib.flash_bwd_dkv.restype = i
        lib.flash_bwd_route.argtypes = [i, i]
        lib.flash_bwd_route.restype = i
        lib.flash_bwd_error_string.argtypes = [i]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _check_rows(name, t, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    # 16-byte vector loads of every row
    step = 16 // t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(s % step for s in t.stride()[:3])):
        raise ValueError(f"{name}: the head dim must be contiguous and "
                         f"every row start 16-byte aligned; got strides "
                         f"{t.stride()}")


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,H,hd) and k/v (B,Sk,Kh,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Sk, Kh, hdk = k.shape
    if Bk != B or hdk != hd or H % Kh:
        raise ValueError(f"mismatched q {tuple(q.shape)} / k "
                         f"{tuple(k.shape)}: batch and head_dim must agree "
                         f"and H must be a multiple of Kh")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"head_dim {hd}: the kernel takes multiples of 16 "
                         f"up to 256")
    if not (1 <= B * H <= 65535 and Sq >= 1 and Sk >= 1):
        raise ValueError(f"B*H={B * H} must lie in [1, 65535] (one grid row "
                         f"each) and Sq={Sq}, Sk={Sk} must be >= 1")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share one dtype of float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, q.device)


def flash_attention_fwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool,
                               window: Optional[int]):
    """q: (B, Sq, H, hd); k/v: (B, Sk, Kh, hd), CUDA, f32 or bf16.

    Returns ``(out (B, Sq, H, hd) in q's dtype, lse (B*H, Sq) f32)``.
    ``window`` is the sliding window in tokens, or None.  Each call that
    launches the kernel adds one to ``flash_attention_fwd_kernel.launches``
    and to its route's entry in ``.launches_by_route``.
    """
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    lib = library()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], B, H, Kh, Sq, Sk, hd,
            ctypes.cast(strides, ctypes.c_void_p), int(causal),
            int(window) if window is not None else 0, 1.0 / (hd ** 0.5),
            stream)
    if code != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {code} "
                           f"({lib.flash_fwd_error_string(code).decode()})")
    flash_attention_fwd_kernel.launches += 1
    flash_attention_fwd_kernel.launches_by_route[route(q.dtype, hd)] += 1
    return out, lse


flash_attention_fwd_kernel.launches = 0
flash_attention_fwd_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: got {tuple(do.shape)} "
                         f"{do.dtype}, q {tuple(q.shape)} {q.dtype}")
    _check_rows("do", do, q.device)
    B, Sq, H, _ = q.shape
    if B * k.shape[2] > 65535:
        raise ValueError(f"B*Kh={B * k.shape[2]} must be <= 65535")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B * H, Sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous (B*H, Sq) = "
                             f"{(B * H, Sq)} float32 tensor on {q.device}; "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")


def _bwd_args(q, k, v, do, lse, delta, causal, window):
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *do.stride()[:3])
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = (_DTYPES[q.dtype], B, H, Kh, Sq, Sk, hd,
            ctypes.cast(strides, ctypes.c_void_p), int(causal),
            int(window) if window is not None else 0, 1.0 / (hd ** 0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail, strides


def _raise_on(code, what):
    if code != 0:
        lib = bwd_library()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({lib.flash_bwd_error_string(code).decode()})")


def flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta, *, causal: bool,
                                  window: Optional[int]) -> torch.Tensor:
    """K2.  q/do: (B, Sq, H, hd); k/v: (B, Sk, Kh, hd), CUDA, f32 or bf16;
    lse/delta: (B*H, Sq) f32 (delta = rowsum(dO * O)).

    Returns dq (B, Sq, H, hd) f32.  Each call that launches the kernel adds
    one to ``flash_attention_bwd_dq_kernel.launches`` and to its route's
    entry in ``.launches_by_route``.
    """
    _check_bwd(q, k, v, do, lse, delta)
    lib = bwd_library()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    head, tail, _keep = _bwd_args(q, k, v, do, lse, delta, causal, window)
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dq(*head, dq.data_ptr(), *tail)
    _raise_on(code, "flash_bwd_dq")
    flash_attention_bwd_dq_kernel.launches += 1
    flash_attention_bwd_dq_kernel.launches_by_route[route(q.dtype,
                                                          q.shape[3])] += 1
    return dq


def flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta, *, causal: bool,
                                   window: Optional[int]):
    """K3.  Inputs as :func:`flash_attention_bwd_dq_kernel`.

    Returns ``(dk, dv)``, each (B, Sk, Kh, hd) f32 and already summed over
    the query heads of its GQA group.  Each call that launches the kernel
    adds one to ``flash_attention_bwd_dkv_kernel.launches`` and to its
    route's entry in ``.launches_by_route``.
    """
    _check_bwd(q, k, v, do, lse, delta)
    lib = bwd_library()
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    head, tail, _keep = _bwd_args(q, k, v, do, lse, delta, causal, window)
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dkv(*head, dk.data_ptr(), dv.data_ptr(), *tail)
    _raise_on(code, "flash_bwd_dkv")
    flash_attention_bwd_dkv_kernel.launches += 1
    flash_attention_bwd_dkv_kernel.launches_by_route[route(q.dtype,
                                                           q.shape[3])] += 1
    return dk, dv


def flash_attention_bwd_kernel(q, k, v, do, lse, delta, *, causal: bool,
                               window: Optional[int]):
    """Backward pass: K2 then K3.  Returns ``(dq (B,Sq,H,hd), dk, dv
    (B,Sk,Kh,hd))``, all f32, dk/dv summed over the GQA group."""
    dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta,
                                       causal=causal, window=window)
    dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                            causal=causal, window=window)
    return dq, dk, dv


flash_attention_bwd_dq_kernel.launches = 0
flash_attention_bwd_dq_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_bwd_dkv_kernel.launches = 0
flash_attention_bwd_dkv_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)

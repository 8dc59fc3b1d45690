"""Public percentile stretch, differentiable.

The counterpart of ``repro.kernels.percentile_norm.ops``: the raster is
flattened to (pixels, bands) in f32, the per-band percentiles are taken
outside the kernel (``ref.percentiles``), and a ``torch.autograd.Function``
takes the place of the reference's ``jax.custom_vjp`` around the stretch.
Its forward runs the hand-written CUDA kernel (K5) on CUDA tensors and the
plain stretch on CPU tensors; no failure on the CUDA path falls back to the
plain version.  Its backward is plain PyTorch and repeats the reference's
``_stretch_bwd``, including the clip subgradient of 0.5 at exact ties
``u == 0`` or ``u == 1``.  ``lo``/``hi`` stay outside the Function, so
their interpolation gradients flow through autograd, as in JAX.  The JAX
package has no backward kernel for the stretch, so neither has the port.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.common import resolve_backend
from repro_torch.kernels.percentile_norm.kernel import percentile_norm_kernel
from repro_torch.kernels.percentile_norm.ref import (EPS, percentiles,
                                                     stretch_ref)


class _Stretch(torch.autograd.Function):

    @staticmethod
    def forward(ctx, flat, lo, hi, use_kernel: bool):
        if use_kernel:
            out = percentile_norm_kernel(flat, lo, hi)
        else:
            out = stretch_ref(flat, lo, hi)
        ctx.save_for_backward(flat, lo, hi)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        flat, lo, hi = ctx.saved_tensors
        x = flat.float()
        s = 1.0 / torch.maximum(hi - lo, torch.full_like(hi, EPS))
        u = (x - lo) * s
        # 1 inside, 0 outside, 0.5 at exact ties (jax's min/max convention)
        w = torch.where((u > 0.0) & (u < 1.0), 1.0,
                        torch.where((u == 0.0) | (u == 1.0), 0.5, 0.0))
        g = ct.float() * w
        dx = (g * s).to(flat.dtype)
        # y = (x - lo) * s, s = 1/(hi - lo): dy/dlo = s (u - 1), dy/dhi = -s u
        dlo = (g * s * (u - 1.0)).sum(0, keepdim=True).to(lo.dtype)
        dhi = (g * (-s) * u).sum(0, keepdim=True).to(hi.dtype)
        return dx, dlo, dhi, None


def percentile_normalize(img: torch.Tensor, *, p_lo: float = 1.0,
                         p_hi: float = 99.0,
                         backend: str = "auto") -> torch.Tensor:
    """img: (..., C) raster -> f32 in [0, 1], the per-band [p_lo, p_hi]
    percentile stretch (the paper's Sentinel-2 normalization).

    ``backend``: ``"auto"`` runs K5 on a CUDA tensor and the plain stretch
    on a CPU tensor; ``"cuda"`` always K5 (a CPU tensor raises);
    ``"torch"`` always the plain stretch.  Every backend differentiates
    through the same ``Function``.
    """
    shape = img.shape
    flat = img.reshape(-1, shape[-1]).float()
    use_kernel = resolve_backend(backend, flat) == "cuda"
    if use_kernel and not flat.is_cuda:
        raise ValueError("backend='cuda' needs a CUDA tensor; got one on "
                         f"{flat.device}")
    pct = percentiles(flat, (p_lo, p_hi))
    out = _Stretch.apply(flat, pct[0:1], pct[1:2], use_kernel)
    return out.reshape(shape)

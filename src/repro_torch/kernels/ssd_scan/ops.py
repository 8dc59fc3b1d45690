"""Public SSD selective scan, differentiable.

A ``torch.autograd.Function`` takes the place of the reference's
``jax.custom_vjp`` (``repro.kernels.ssd_scan.ops``).  Its forward runs the
hand-written CUDA kernel (K4) on CUDA tensors and the plain chunked scan
(``ref.ssd_chunked_ref``) on CPU tensors; no failure on the CUDA path falls
back to the plain version.  Its backward recomputes the forward through the
plain chunked scan under autograd and differentiates that, as the
reference's ``_ssd_bwd`` differentiates ``_ssd_jnp_equiv``: the JAX package
has no Pallas backward for this kernel.

B and C keep their ``(Bs, S, g, N)`` group layout all the way into the
kernel; they are never repeated per head.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.common import resolve_backend
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        if x.is_cuda:
            y, h = ssd_scan_kernel(x, dt, A, B, C, chunk=chunk)
        else:
            y, h = ssd_chunked_ref(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, h = ssd_chunked_ref(*inputs, ctx.chunk)
            grads = torch.autograd.grad((y, h), inputs, (dy, dh))
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             return_state: bool = False, backend: str = "auto"):
    """SSD selective scan.  x: (Bs, S, nh, hp); dt: (Bs, S, nh); A: (nh,);
    B/C: (Bs, S, g, N) group-shared.  Returns y (Bs, S, nh, hp) in x's
    dtype, or ``(y, h_final (Bs, nh, hp, N) f32)`` with ``return_state``.

    ``backend``: ``"auto"`` or ``"cuda"`` go through the differentiable
    ``Function`` (K4 on CUDA tensors, the plain chunked scan on CPU
    tensors); ``"torch"`` runs the plain chunked scan under autograd.
    dt and A are taken in f32, as the kernel reads them.
    """
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape \
            or x.shape[2] % B.shape[2]:
        raise ValueError(f"want x (Bs,S,nh,hp) and B/C (Bs,S,g,N) with nh a "
                         f"multiple of g; got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    devices = {t.device.type for t in (x, dt, A, B, C)}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"x/dt/A/B/C must all lie on the CPU or all on "
                         f"CUDA; got {sorted(devices)}")
    dt, A = dt.float(), A.float()
    if resolve_backend(backend, x) == "torch":
        y, h = ssd_chunked_ref(x, dt, A, B, C, chunk)
    else:
        y, h = _SSDScan.apply(x, dt, A, B, C, chunk)
    return (y, h) if return_state else y

"""Public flash attention on the (B, S, H, hd) layout, differentiable.

A ``torch.autograd.Function`` takes the place of the reference's
``jax.custom_vjp`` (``repro.kernels.flash_attention.ops``).  Its forward
runs the hand-written forward kernel (K1) and keeps ``q, k, v, out`` and the
per-row logsumexp as residuals; its backward computes ``D = rowsum(dO O)``
as a plain tensor op and runs the backward kernels, dQ (K2) and dK/dV (K3),
which sum dK/dV over the GQA group themselves.

A CPU tensor goes to the plain PyTorch versions (``ref.attention_ref``,
``ref.attention_bwd_ref``) through the same ``Function``; a CUDA tensor
goes to the kernels or raises.  No failure on the CUDA path falls back to
the plain versions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_kernel, flash_attention_fwd_kernel)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref,
                                                     row_delta)


def _validate(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,H,hd) and k/v (B,Sk,Kh,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    Sq, Sk = q.shape[1], k.shape[1]
    if Sk < 1:
        raise ValueError("attention needs at least one key")
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1; got {window}")
        # rows q >= Sk - 1 + window would see no key at all
        if Sq >= Sk + window:
            raise ValueError(f"window {window} leaves query rows >= "
                             f"{Sk - 1 + window} with no admissible key "
                             f"(Sq={Sq}, Sk={Sk})")


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.is_cuda:
            out, lse = flash_attention_fwd_kernel(q, k, v, causal=causal,
                                                  window=window)
        else:
            out, lse = attention_ref(q, k, v, causal=causal, window=window)
        # residual is `out` itself, as in the reference: autograd keeps it
        # alive anyway (it feeds the wo matmul)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd_kernel(
                q, k, v, do, lse, row_delta(out, do), causal=ctx.causal,
                window=ctx.window)
        else:
            dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, do,
                                           causal=ctx.causal,
                                           window=ctx.window)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, Kh, hd) -> (B, Sq, H, hd).

    Differentiable: a gradient through this op runs the backward kernels
    on CUDA tensors and their plain versions on CPU tensors.
    """
    _validate(q, k, v, window)
    devices = {q.device.type, k.device.type, v.device.type}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"q/k/v must all lie on the CPU or all on CUDA; "
                         f"got {q.device}, {k.device}, {v.device}")
    return _FlashAttention.apply(q, k, v, causal, window)

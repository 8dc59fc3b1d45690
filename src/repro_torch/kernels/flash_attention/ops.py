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
the plain versions.  A ``meta`` tensor (the dry run's trace) goes to
:mod:`.meta`: the kernels' output shapes, and their operations counted for
``FlopCounterMode``; nothing runs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_kernel, flash_attention_fwd_kernel)
from repro_torch.kernels.flash_attention.meta import (flash_bwd_meta,
                                                      flash_fwd_meta)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref,
                                                     row_delta)


def _validate(q, k, v, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,H,hd) and k/v (B,Sk,Kh,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    Sq, Sk = q.shape[1], k.shape[1]
    if Sk < 1:
        raise ValueError("attention needs at least one key")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0; got {q_offset}")
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1; got {window}")
        # positions q >= Sk - 1 + window would see no key at all
        if q_offset + Sq >= Sk + window:
            raise ValueError(f"window {window} leaves query positions >= "
                             f"{Sk - 1 + window} with no admissible key "
                             f"(Sq={Sq}, Sk={Sk}, q_offset={q_offset})")


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        mask = dict(causal=causal, window=window, q_offset=q_offset)
        if q.is_cuda:
            out, lse = flash_attention_fwd_kernel(q, k, v, **mask)
        elif q.is_meta:
            out, lse = flash_fwd_meta(q, k, v, **mask)
        else:
            out, lse = attention_ref(q, k, v, **mask)
        # residual is `out` itself, as in the reference: autograd keeps it
        # alive anyway (it feeds the wo matmul)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd_kernel(
                q, k, v, do, lse, row_delta(out, do), **ctx.mask)
        elif q.is_meta:
            dq, dk, dv = flash_bwd_meta(q, k, v, do, lse, row_delta(out, do),
                                        **ctx.mask)
        else:
            dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, do, **ctx.mask)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, Kh, hd) -> (B, Sq, H, hd).

    The queries sit at absolute positions ``q_offset + i`` and the keys at
    ``j`` (the reference's ``naive_attention(q_offset=...)``): a sequence
    block's queries against the gathered keys of the whole sequence.

    Differentiable: a gradient through this op runs the backward kernels
    on CUDA tensors and their plain versions on CPU tensors; on meta
    tensors both directions give shapes and counted operations only.
    """
    _validate(q, k, v, window, q_offset)
    devices = {q.device.type, k.device.type, v.device.type}
    if devices not in ({"cpu"}, {"cuda"}, {"meta"}):
        raise ValueError(f"q/k/v must all lie on the CPU, all on CUDA or "
                         f"all on meta; got {q.device}, {k.device}, "
                         f"{v.device}")
    return _FlashAttention.apply(q, k, v, causal, window, int(q_offset))

"""Public flash-attention forward on the (B, S, H, hd) layout.

A CPU tensor goes to the plain PyTorch version (``ref.attention_ref``); a
CUDA tensor goes to the hand-written kernel (``kernel.py``) or raises.  No
failure on the CUDA path falls back to the plain version.  Forward only:
the backward kernels belong to the training path, so a CUDA call that would
need a gradient raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_fwd_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, Kh, hd) -> (B, Sq, H, hd)."""
    _validate(q, k, v, window)
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cpu"}:
        return attention_ref(q, k, v, causal=causal, window=window)[0]
    if devices != {"cuda"}:
        raise ValueError(f"q/k/v must all lie on the CPU or all on CUDA; "
                         f"got {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the CUDA flash-attention backward is not ported yet; run "
            "under torch.no_grad() or use attention_backend='torch'")
    return flash_attention_fwd_kernel(q, k, v, causal=causal,
                                      window=window)[0]

"""Plain PyTorch versions of the flash-attention kernels.

The CPU path of :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` and the yardstick the CUDA kernels are held against on the
card.  They repeat the kernels' arithmetic on whole rows.  Forward: scores
in f32 from the pre-scaled query, the same masks from absolute positions, P
rounded to V's dtype before the P V product, which accumulates in f32, and
the per-row logsumexp ``L = m + log(max(l, 1e-30))``.  Backward: P =
exp(S - L) in f32 (not rounded), dP = dO V^T, dS = P (dP - D) with D =
rowsum(dO O), and dQ, dK, dV in f32, dK/dV summed over the GQA group.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
                   device=None, q_offset: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: kv padding is implicit (k < Sk); causal ``k <= q``;
    window ``k > q - window``; query row i sits at ``q = q_offset + i`` and
    key j at ``j`` (q_offset 0: top-left aligned)."""
    qp = q_offset + torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, Kh, hd); the queries at absolute
    positions ``q_offset + i``.

    Returns ``(out (B, Sq, H, hd) in q's dtype, lse (B*H, Sq) f32)``.
    GQA reads kv head ``h // (H // Kh)`` through a broadcast view, so K and
    V are not repeated in memory.
    """
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    scale = 1.0 / (hd ** 0.5)
    # (B, Kh, rep, Sq, hd) query groups against (B, Kh, 1, Sk, hd) keys
    qg = (q.float() * scale).reshape(B, Sq, Kh, rep, hd).permute(0, 2, 3, 1, 4)
    kg = k.float().permute(0, 2, 1, 3)[:, :, None]
    vg = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = qg @ kg.transpose(-1, -2)                          # (B,Kh,rep,Sq,Sk)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          device=q.device, q_offset=q_offset)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = p.to(v.dtype).float() @ vg                       # (B,Kh,rep,Sq,hd)
    out = (pv / l).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].reshape(B * H, Sq)
    return out, lse


def row_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * O)`` in f32, as (B*H, Sq): the backward's per-row
    term (the reference's ``ops.py::_flash_bwd``)."""
    B, Sq, H, _ = out.shape
    d = (do.float() * out.float()).sum(dim=-1)              # (B, Sq, H)
    return d.permute(0, 2, 1).reshape(B * H, Sq).contiguous()


def attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0):
    """q/out/do: (B, Sq, H, hd); k/v: (B, Sk, Kh, hd); lse: (B*H, Sq) f32
    from the forward (of the same ``q_offset``).

    Returns ``(dq (B,Sq,H,hd), dk, dv (B,Sk,Kh,hd))``, all f32, dk/dv
    summed over the query heads of each kv head's group.
    """
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    scale = 1.0 / (hd ** 0.5)

    def groups(x):                                  # -> (B, Kh, rep, S, hd)
        return x.float().reshape(B, Sq, Kh, rep, hd).permute(0, 2, 3, 1, 4)

    qg, dog = groups(q), groups(do)
    kg = k.float().permute(0, 2, 1, 3)[:, :, None]          # (B,Kh,1,Sk,hd)
    vg = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qg * scale) @ kg.transpose(-1, -2)                 # (B,Kh,rep,Sq,Sk)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          device=q.device, q_offset=q_offset)
    lse_g = lse.reshape(B, Kh, rep, Sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dp = dog @ vg.transpose(-1, -2)
    delta = row_delta(out, do).reshape(B, Kh, rep, Sq)[..., None]
    ds = p * (dp - delta)
    dq = (ds @ kg) * scale                                  # (B,Kh,rep,Sq,hd)
    dk = (ds.transpose(-1, -2) @ qg).sum(dim=2) * scale     # (B,Kh,Sk,hd)
    dv = (p.transpose(-1, -2) @ dog).sum(dim=2)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)

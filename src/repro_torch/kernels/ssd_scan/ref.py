"""Plain PyTorch versions of the Mamba2 SSD chunk scan.

* :func:`ssd_ref` — the sequential-recurrence oracle,
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = C_t . h_t``
  (``repro.kernels.ssd_scan.ref.ssd_ref``).
* :func:`ssd_chunked_ref` — the chunked scan, term for term as the
  reference's ``ops._ssd_jnp_equiv`` (f32 compute, the masked-exponent
  intra-chunk products, the carried state), with an optional initial state.
  It is the CPU path of :func:`repro_torch.kernels.ssd_scan.ssd_scan`, the
  yardstick the CUDA kernel (K4) is held against on the card, and the
  recompute path of the scan's backward.

B and C stay ``(Bs, S, g, N)``: head ``h`` reads group ``h // (nh // g)``
through a broadcast view, so they are never repeated per head in memory.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ssd_ref(x, dt, A, B, C):
    """x: (Bs, S, nh, hp); dt: (Bs, S, nh); A: (nh,) negative;
    B/C: (Bs, S, g, N).  Returns ``(y in x's dtype, h_final (Bs, nh, hp, N)
    f32)``."""
    Bs, S, nh, hp = x.shape
    rep = nh // B.shape[2]
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = torch.zeros((Bs, nh, hp, B.shape[3]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * Af)
        h = a[..., None, None] * h + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked_ref(x, dt, A, B, C, chunk: int,
                    h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.  x: (Bs, S, nh, hp); dt: (Bs, S, nh); A: (nh,);
    B/C: (Bs, S, g, N); ``h0`` (Bs, nh, hp, N) f32 or None (zeros).

    Returns ``(y (Bs, S, nh, hp) in x's dtype, h_final (Bs, nh, hp, N)
    f32)``.  S is padded to a multiple of the chunk ``Q = min(chunk, S)``
    with zero dt, which freezes the carried state over the pad, so y[:, :S]
    and h_final are exact.  Differentiable with autograd.
    """
    Bs, S, nh, hp = x.shape
    g, N = B.shape[2], B.shape[3]
    rep = nh // g
    in_dtype = x.dtype
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // Q
    # heads split as (g, rep): head h = group h // rep, member h % rep
    xf = x.float().reshape(Bs, nc, Q, g, rep, hp)
    dtc = dt.float().reshape(Bs, nc, Q, g, rep)
    Bc = B.float().reshape(Bs, nc, Q, g, N)
    Cc = C.float().reshape(Bs, nc, Q, g, N)
    Af = A.float().reshape(g, rep)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # (Bs, g, rep, hp, N)
    h = (torch.zeros((Bs, g, rep, hp, N), dtype=torch.float32,
                     device=x.device) if h0 is None
         else h0.float().reshape(Bs, g, rep, hp, N))
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xf[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        la = torch.cumsum(dtq * Af, dim=1)                 # (Bs,Q,g,rep)
        la_last = la[:, -1]                                # (Bs,g,rep)
        G = torch.einsum("bign,bjgn->bijg", Cq, Bq)        # (Bs,Q,Q,g)
        # mask the EXPONENT, not the product: the upper triangle of
        # exp(la_i - la_j) overflows to inf, and inf * 0 is NaN
        diff = la[:, :, None] - la[:, None, :]             # (Bs,Q,Q,g,rep)
        diff = diff.masked_fill(~tri[None, :, :, None, None], float("-inf"))
        M = G[..., None] * torch.exp(diff)
        y = torch.einsum("bijgr,bjgr,bjgrp->bigrp", M, dtq, xq)
        Cd = Cq[:, :, :, None, :] * torch.exp(la)[..., None]
        y = y + torch.einsum("bigrn,bgrpn->bigrp", Cd, h)
        decay_out = torch.exp(la_last[:, None] - la) * dtq
        h = torch.exp(la_last)[..., None, None] * h + torch.einsum(
            "bjgrp,bjgn->bgrpn", xq * decay_out[..., None], Bq)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bs, nc * Q, nh, hp)[:, :S]
    return y.to(in_dtype), h.reshape(Bs, nh, hp, N)

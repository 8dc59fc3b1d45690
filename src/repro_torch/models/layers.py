"""Core layers of the dense decoder: norms, projections, RoPE, attention
(GQA, causal / bidirectional / sliding-window; prefill and decode paths)
and gated MLPs.  Port of ``repro.models.layers``.

Parameters are plain dicts of tensors, as in the reference; every layer is
an ``init`` + ``apply`` pair of functions.  The reference's sharding
constraints have no counterpart on one card and are dropped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import resolve_backend
from repro_torch.kernels.flash_attention import flash_attention

DEFAULT_INIT_SCALE = 0.02


# --------------------------------------------------------------------------
# basics
# --------------------------------------------------------------------------
def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> dict:
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=device) * DEFAULT_INIT_SCALE
    return {"w": w.to(dtype)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


def norm_init(kind: str, d: int, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    """rmsnorm (eps 1e-6) or layernorm (eps 1e-5), computed in f32 and cast
    back to ``x``'s dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
    else:
        raise ValueError(kind)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embedding (split-half, not interleaved)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs    # (...,S,1,hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------
def mlp_init(generator, d: int, d_ff: int, act: str, dtype, device) -> dict:
    p = {"up": dense_init(generator, d, d_ff, dtype, device),
         "down": dense_init(generator, d_ff, d, dtype, device)}
    if act == "silu":  # gated
        p["gate"] = dense_init(generator, d, d_ff, dtype, device)
    return p


def mlp_apply(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = dense(params["up"], x)
    if act == "silu":
        h = F.silu(dense(params["gate"], x)) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return dense(params["down"], h)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None     # sliding window (tokens), None = full
    rope_theta: float = 10_000.0
    # kernel backend for prefill self-attention: "torch" (naive_attention),
    # "cuda" (the hand-written flash-attention kernel; its plain version
    # on CPU tensors) or "auto" (cuda for CUDA tensors, torch otherwise).
    backend: str = "torch"


def attn_init(generator, d_model: int, spec: AttnSpec, dtype,
              device) -> dict:
    return {
        "wq": dense_init(generator, d_model, spec.n_heads * spec.head_dim,
                         dtype, device),
        "wk": dense_init(generator, d_model,
                         spec.n_kv_heads * spec.head_dim, dtype, device),
        "wv": dense_init(generator, d_model,
                         spec.n_kv_heads * spec.head_dim, dtype, device),
        "wo": dense_init(generator, spec.n_heads * spec.head_dim, d_model,
                         dtype, device),
    }


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _mask_bias(q_pos, k_pos, causal, window):
    """(Sq, Sk) additive bias from absolute positions."""
    m = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32,
                    device=q_pos.device)
    if causal:
        m = m.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
    if window is not None:
        m = m.masked_fill(k_pos[None, :] <= q_pos[:, None] - window, NEG_INF)
    return m


def naive_attention(q, k, v, *, causal, window):
    """q: (B,Sq,H,hd), k/v: (B,Sk,Kh,hd).  Plain whole-row attention.

    GQA is computed against the un-repeated K/V (grouped product), so no
    H-sized key/value tensor is materialised.
    """
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    qg = q.reshape(B, Sq, Kh, rep, hd).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    scores = scores / math.sqrt(hd)
    if causal or window is not None:
        # unmasked, the reference adds zeros: skipped, which saves an
        # (Sq, Sk) bias and a scores-sized sum (ChangeFormer's 16k tokens)
        pos_q = torch.arange(Sq, device=q.device)
        pos_k = torch.arange(Sk, device=q.device)
        scores = scores + _mask_bias(pos_q, pos_k, causal, window)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attn_apply(params: dict, x: torch.Tensor, spec: AttnSpec,
               positions: torch.Tensor, return_kv: bool = False):
    """Prefill self-attention.  x: (B,S,d); positions: (B,S)."""
    B, S, _ = x.shape
    q = _split_heads(dense(params["wq"], x), spec.n_heads, spec.head_dim)
    k = _split_heads(dense(params["wk"], x), spec.n_kv_heads, spec.head_dim)
    v = _split_heads(dense(params["wv"], x), spec.n_kv_heads, spec.head_dim)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    window = spec.window if (spec.window and spec.window < S) else None
    if resolve_backend(spec.backend, q) == "cuda":
        out = flash_attention(q, k, v, causal=spec.causal, window=window)
    else:
        out = naive_attention(q, k, v, causal=spec.causal, window=window)
    out = out.reshape(B, S, spec.n_heads * spec.head_dim)
    out = dense(params["wo"], out)
    if return_kv:
        return out, (k, v)
    return out


def kv_to_cache(k: torch.Tensor, v: torch.Tensor, cache_len: int, dtype,
                lengths: Optional[torch.Tensor] = None) -> dict:
    """Place prefill keys/values (B,S,Kh,hd) into the decode cache layout
    (ring buffer of ``cache_len`` slots; slot for position p is
    ``p % cache_len``).

    ``lengths`` ((B,) int, optional) marks true per-row prompt lengths for
    right-padded batches: slot j then takes the row's last kept position
    congruent to j — ``(len-1) - ((len-1-j) % cache_len)`` — the same ring
    layout :func:`attn_decode` expects, so pad keys never enter the cache.
    """
    B, S, Kh, hd = k.shape
    if lengths is None:
        buf_k = torch.zeros((B, cache_len, Kh, hd), dtype=dtype,
                            device=k.device)
        buf_v = torch.zeros_like(buf_k)
        start = max(0, S - cache_len)
        slots = torch.arange(start, S, device=k.device) % cache_len
        buf_k[:, slots] = k[:, start:].to(dtype)
        buf_v[:, slots] = v[:, start:].to(dtype)
        return {"k": buf_k, "v": buf_v}
    j = torch.arange(cache_len, device=k.device)[None, :]     # (1, L)
    last = lengths.to(k.device).long()[:, None] - 1           # (B, 1)
    pos = last - torch.remainder(last - j, cache_len)         # (B, L)
    valid = (pos >= 0)[..., None, None]
    idx = pos.clamp(0, S - 1)[..., None, None].expand(B, cache_len, Kh, hd)
    buf_k = torch.where(valid, torch.gather(k, 1, idx), 0)
    buf_v = torch.where(valid, torch.gather(v, 1, idx), 0)
    return {"k": buf_k.to(dtype), "v": buf_v.to(dtype)}


# --------------------------------------------------------------------------
# decode with KV cache (full-length or ring-buffer sliding window)
# --------------------------------------------------------------------------
def kv_cache_init(batch: int, cache_len: int, spec: AttnSpec, dtype,
                  device) -> dict:
    shp = (batch, cache_len, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def attn_decode(params: dict, cache: dict, x: torch.Tensor, spec: AttnSpec,
                position: torch.Tensor):
    """One-token decode.  x: (B,1,d); position: (B,) absolute position.

    The cache holds RoPE'd keys at absolute positions; the slot for
    position p is ``p % cache_len``, and slots further than ``window`` back
    (or not yet written) are masked out.  The new key and value are written
    into ``cache`` **in place** (the reference donates the cache to get the
    same effect); the updated cache is also returned.
    """
    B = x.shape[0]
    cache_len = cache["k"].shape[1]
    q = _split_heads(dense(params["wq"], x), spec.n_heads, spec.head_dim)
    k = _split_heads(dense(params["wk"], x), spec.n_kv_heads, spec.head_dim)
    v = _split_heads(dense(params["wv"], x), spec.n_kv_heads, spec.head_dim)
    q = apply_rope(q, position[:, None], spec.rope_theta)
    k = apply_rope(k, position[:, None], spec.rope_theta)

    position = position.long()
    slot = torch.remainder(position, cache_len)               # (B,)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)

    Kh, hd = spec.n_kv_heads, spec.head_dim
    rep = spec.n_heads // Kh
    qg = q.reshape(B, 1, Kh, rep, hd).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, cache["k"].float())
    scores = scores / math.sqrt(hd)
    # slot j's latest write is pos - ((pos - j) % cache_len); it is valid
    # iff it has been written and lies within the window
    j = torch.arange(cache_len, device=x.device)[None, :]     # (1, L)
    abs_pos = position[:, None] - torch.remainder(position[:, None] - j,
                                                  cache_len)
    valid = abs_pos >= 0
    if spec.window is not None:
        valid &= abs_pos > position[:, None] - spec.window
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cache["v"].float())
    out = out.reshape(B, 1, spec.n_heads * hd).to(x.dtype)
    return dense(params["wo"], out), cache

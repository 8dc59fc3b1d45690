"""Core layers of the dense decoder: norms, projections, RoPE, attention
(GQA, causal / bidirectional / sliding-window; prefill and decode paths)
and gated MLPs.  Port of ``repro.models.layers``.

Parameters are plain dicts of tensors, as in the reference; every layer is
an ``init`` + ``apply`` pair of functions.  The reference's sharding
constraints (``constrain``) have no counterpart: the port's activations
are one rank's own tensors (:mod:`repro_torch.sharding`).  Nor has its
``_multi_device``: the reference leaves its Pallas attention under a
multi-device ctx because ``pallas_call`` has no GSPMD partitioning rule,
but a rank of the port runs local tensors, so K1-K3 stay on the
parameter-sharded path too.

Under a model axis (``tp``, a :class:`repro_torch.sharding.tp.TP`) the
attention runs on the rank's ``n_heads / M`` query heads and their kv
heads, K1-K3 called on those local heads unchanged, and ``wo`` is
row-parallel; the MLP's ``up``/``gate`` are column-parallel and its
``down`` row-parallel.  In decode the KV cache holds every kv head over
the rank's block of the slots, the split the reference asks XLA for
(``decode_state_shardings``): the prefill sends its kv heads' keys and
values to the slots' owners, a decode step gathers the token's q, k and
v from the ranks' heads, and the softmax over the slots is distributed
as under ``fsdp_sp`` (:func:`attn_decode`).

Under the sequence split of ``fsdp_sp`` (``sp``, a
:class:`repro_torch.sharding.sp.SP`) the attention computes q, k and v
on the rank's block of the sequence with the whole weights, applies
RoPE at the block's absolute positions, all-gathers K and V and runs
the block's queries against every key at ``q_offset``, the block's
first position (K1-K3 on CUDA tensors, the plain version on the CPU);
``wo`` runs on the rank's rows with no reduction, the heads being
whole.  The MLP gathers the sequence before its column blocks and
reduce-scatters its row block's partial sums after them.  In decode the
cache holds the rank's block of the slots (``decode_state_shardings``'s
sequence split), and the softmax over them is distributed
(:func:`attn_decode`).
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


def mlp_apply(params: dict, x: torch.Tensor, act: str, tp=None,
              sp=None) -> torch.Tensor:
    """The MLP of ``x``; under ``tp`` on the rank's ``d_ff / M``
    columns, the partial sums all-reduced; under ``sp`` on those columns
    over the whole sequence, the partial sums reduce-scattered to the
    ranks' blocks."""
    if sp is not None:
        return sp.scatter_seq(_mlp(params, sp.gather_seq(x), act))
    if tp is None:
        return _mlp(params, x, act)
    return tp.exit(_mlp(params, tp.enter(x), act))


def _mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
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


def naive_attention(q, k, v, *, causal, window, q_offset=0):
    """q: (B,Sq,H,hd), k/v: (B,Sk,Kh,hd).  Plain whole-row attention;
    the queries sit at absolute positions ``q_offset + i``, the keys at
    ``j``.

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
        pos_q = q_offset + torch.arange(Sq, device=q.device)
        pos_k = torch.arange(Sk, device=q.device)
        scores = scores + _mask_bias(pos_q, pos_k, causal, window)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attn_apply(params: dict, x: torch.Tensor, spec: AttnSpec,
               positions: torch.Tensor, return_kv: bool = False, tp=None,
               sp=None):
    """Prefill self-attention.  x: (B,S,d); positions: (B,S).  Under
    ``tp`` the rank's heads (and its kv heads' K/V), ``wo``'s partial
    sums all-reduced.  Under ``sp`` x and positions are the rank's block
    of the sequence, and the K/V returned are the whole sequence's."""
    B, S, _ = x.shape
    q_offset, whole = (0, S) if sp is None else sp.block(S)
    if tp is not None:
        params, spec = tp.attn(params, spec)
        x = tp.attn_enter(x)
    q = _split_heads(dense(params["wq"], x), spec.n_heads, spec.head_dim)
    k = _split_heads(dense(params["wk"], x), spec.n_kv_heads, spec.head_dim)
    v = _split_heads(dense(params["wv"], x), spec.n_kv_heads, spec.head_dim)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    if sp is not None:
        k, v = sp.gather_kv(k, v)
    window = spec.window if (spec.window and spec.window < whole) else None
    mask = dict(causal=spec.causal, window=window, q_offset=q_offset)
    if resolve_backend(spec.backend, q) == "cuda":
        out = flash_attention(q, k, v, **mask)
    else:
        out = naive_attention(q, k, v, **mask)
    out = out.reshape(B, S, spec.n_heads * spec.head_dim)
    out = dense(params["wo"], out)
    if tp is not None:
        out = tp.attn_exit(out)
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
                position: torch.Tensor, tp=None, sp=None,
                cache_len: Optional[int] = None):
    """One-token decode.  x: (B,1,d); position: (B,) absolute position.

    The cache holds RoPE'd keys at absolute positions; the slot for
    position p is ``p % cache_len``, and slots further than ``window`` back
    (or not yet written) are masked out.  The new key and value are written
    into ``cache`` **in place** (the reference donates the cache to get the
    same effect); the updated cache is also returned.  On a model axis
    (``tp`` or ``sp``) the cache holds the rank's block of the
    ``cache_len`` slots (all of them where the axis does not divide
    ``cache_len``) and every kv head, and the softmax over the slots is
    distributed (:func:`_decode_split`).
    """
    B = x.shape[0]
    if sp is not None or tp is not None:
        return _decode_split(params, cache, x, spec, position, tp, sp,
                             cache_len)
    cache_len = cache["k"].shape[1]
    q, k, v = _qkv_decode(params, x, spec, position)

    position = position.long()
    slot = torch.remainder(position, cache_len)               # (B,)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)

    scores = _decode_scores(q, cache, spec)
    valid = _valid_slots(position, 0, cache_len, cache_len, spec.window)
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cache["v"].float())
    out = out.reshape(B, 1, spec.n_heads * spec.head_dim).to(x.dtype)
    return dense(params["wo"], out), cache


def _qkv_decode(params, x, spec: AttnSpec, position):
    """q (B,1,H,hd), k and v (B,1,Kh,hd) of the token, RoPE'd at
    ``position``."""
    q = _split_heads(dense(params["wq"], x), spec.n_heads, spec.head_dim)
    k = _split_heads(dense(params["wk"], x), spec.n_kv_heads, spec.head_dim)
    v = _split_heads(dense(params["wv"], x), spec.n_kv_heads, spec.head_dim)
    q = apply_rope(q, position[:, None], spec.rope_theta)
    k = apply_rope(k, position[:, None], spec.rope_theta)
    return q, k, v


def _decode_scores(q, cache, spec: AttnSpec):
    """(B, Kh, rep, 1, L) f32 scores of q against the cache's keys."""
    B, Kh, hd = q.shape[0], spec.n_kv_heads, spec.head_dim
    qg = q.reshape(B, 1, Kh, spec.n_heads // Kh, hd).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, cache["k"].float())
    return scores / math.sqrt(hd)


def _valid_slots(position, lo: int, n: int, cache_len: int, window):
    """(B, n) bool: whether slots ``[lo, lo + n)`` of a ring of
    ``cache_len`` hold a position the token at ``position`` attends:
    slot j's latest write is ``pos - ((pos - j) % cache_len)``, valid iff
    it has been written and lies within the window."""
    j = lo + torch.arange(n, device=position.device)[None, :]
    abs_pos = position[:, None] - torch.remainder(position[:, None] - j,
                                                  cache_len)
    valid = abs_pos >= 0
    if window is not None:
        valid &= abs_pos > position[:, None] - window
    return valid


def _decode_split(params, cache, x, spec: AttnSpec, position, tp, sp,
                  cache_len: Optional[int]):
    """:func:`attn_decode` on the rank's slots ``[lo, hi)`` of the
    ``cache_len``-slot ring (``span``), every head whole.  The token's
    q, k and v: under ``sp`` computed by every rank with the whole
    weights; under ``tp`` on the rank's heads (column-parallel, as in
    prefill), then all-gathered whole (``TP.gather_qkv``; where the
    attention runs whole, computed whole).  The owner of slot ``p %
    cache_len`` writes k and v (the others write their slot back
    unchanged: no branch on the data).  Each rank scores every head
    against its slots under the world-1 mask, in f32, and keeps its row
    max, its sum of ``exp(s - max)`` over the valid slots and their P·V;
    a split cache's partials are combined over the model group
    (``combine_softmax``), a whole one's are the softmax itself.  Under
    ``sp`` ``wo`` takes every head; under ``tp`` the rank keeps its heads'
    columns for the row-parallel ``wo``, its partial sums all-reduced."""
    if cache_len is None:
        raise ValueError("a decode step on a model axis needs the cache's "
                         "whole length: a rank holds a block of it")
    B = x.shape[0]
    axis = sp if tp is None else tp
    if tp is None:
        q, k, v = _qkv_decode(params, x, spec, position)
    else:
        local, local_spec = tp.attn(params, spec)
        q, k, v = _qkv_decode(local, tp.attn_enter(x), local_spec, position)
        if not tp.heads_whole:
            q, k, v = tp.gather_qkv(q, k, v)
    lo, hi = axis.span(cache_len)
    n = hi - lo
    if cache["k"].shape[1] != n:
        raise ValueError(f"a cache block of {cache['k'].shape[1]} slots; "
                         f"the rank's block of {cache_len} is {n}")
    position = position.long()
    local_slot = torch.remainder(position, cache_len) - lo
    own = ((local_slot >= 0) & (local_slot < n))[:, None, None]
    idx = local_slot.clamp(0, n - 1)
    bidx = torch.arange(B, device=x.device)
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        buf[bidx, idx] = torch.where(own, new[:, 0].to(buf.dtype),
                                     buf[bidx, idx])

    scores = _decode_scores(q, cache, spec)
    valid = _valid_slots(position, lo, n, cache_len, spec.window)
    valid = valid[:, None, None, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)
    mx = scores.amax(dim=-1, keepdim=True)                # (B,Kh,rep,1,1)
    p = torch.exp(scores - mx) * valid
    denom = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bgrqk,bkgd->bgrqd", p, cache["v"].float())
    if n == cache_len:
        out = pv / denom
    else:
        out = axis.combine_softmax(mx, denom, pv)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, spec.n_heads
                                             * spec.head_dim).to(x.dtype)
    if tp is None:
        return dense(params["wo"], out), cache
    if not tp.heads_whole:
        q0, q1 = tp.plan.q_heads
        out = out[..., q0 * spec.head_dim:q1 * spec.head_dim]
    return tp.attn_exit(dense(local["wo"], out)), cache

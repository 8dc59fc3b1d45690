"""Dense decoder assembly for inference: init, prefill, decode and the
sampling head.  Port of the dense text path of ``repro.models.model``.

The reference stacks each period's parameters and scans over periods with
``jax.lax.scan``; here ``params["layers"]`` is a list of per-layer dicts
and the stack is a Python loop.  The decode state holds every layer's KV
cache in two stacked tensors, ``{"k", "v"}`` of shape (n_layers, B, L, Kh,
hd), updated in place by :func:`decode_step` (the reference donates it).
Families other than ``dense`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L


# --------------------------------------------------------------------------
# structure helpers
# --------------------------------------------------------------------------
def _require_dense(cfg: ArchConfig) -> None:
    """Every layer must be attention + a dense MLP: the only stack ported."""
    if cfg.family != "dense" or _slot_plan(cfg) != [("attn", False, True)]:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"serves dense decoders")


def period_len(cfg: ArchConfig) -> int:
    p = 1
    if cfg.attn_every:
        p = math.lcm(p, cfg.attn_every)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of the period {p}")
    return p


def _slot_plan(cfg: ArchConfig):
    """[(kind, has_moe, has_dense_ffn)] for each slot within one period."""
    p = period_len(cfg)
    kinds = cfg.layer_kinds()[:p]
    moe_mask = cfg.moe_layer_mask()[:p]
    plan = []
    for i in range(p):
        has_moe = moe_mask[i]
        has_dense = (cfg.d_ff > 0) and not has_moe
        plan.append((kinds[i], has_moe, has_dense))
    return plan


def attn_spec(cfg: ArchConfig) -> L.AttnSpec:
    return L.AttnSpec(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        causal=cfg.causal,
        window=cfg.sliding_window,
        rope_theta=cfg.rope_theta,
        backend=cfg.attention_backend,
    )


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _attn_len(cfg: ArchConfig, cache_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cache_len, cfg.sliding_window)
    return cache_len


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> Dict[str, Any]:
    """Random parameters: normal(0, 0.02) matrices, unit norm scales.

    ``generator`` must live on ``device``; by default one seeded with 0 is
    made there.  ``device`` defaults to ``cuda`` and raises without a card.
    The numbers differ from the reference's ``jax.random`` draw; to run
    the reference's weights, convert them with
    :func:`repro_torch.convert.params_from_flat`.
    """
    _require_dense(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = param_dtype(cfg)
    d = cfg.d_model
    spec = attn_spec(cfg)
    g = generator
    embed = (torch.randn((cfg.vocab, d), generator=g, dtype=torch.float32,
                         device=device) * L.DEFAULT_INIT_SCALE).to(dtype)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "norm1": L.norm_init(cfg.norm, d, dtype, device),
            "norm2": L.norm_init(cfg.norm, d, dtype, device),
            "attn": L.attn_init(g, d, spec, dtype, device),
            "mlp": L.mlp_init(g, d, cfg.d_ff, cfg.act, dtype, device),
        })
    params = {"embed": {"w": embed},
              "final_norm": L.norm_init(cfg.norm, d, dtype, device),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(g, d, cfg.vocab, dtype, device)
    return params


# --------------------------------------------------------------------------
# forward pieces
# --------------------------------------------------------------------------
def embed_inputs(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """Text inputs only.  Returns (x (B,S,d), positions (B,S))."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = params["embed"]["w"][tokens.long()]
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions


def logits_fn(params, cfg: ArchConfig, x):
    w = (params["embed"]["w"].T if cfg.tie_embeddings
         else params["head"]["w"])
    return x @ w


def _ffn(layer, cfg: ArchConfig, x):
    h = L.norm_apply(cfg.norm, layer["norm2"], x)
    return x + L.mlp_apply(layer["mlp"], h, cfg.act)


# --------------------------------------------------------------------------
# prefill (fills the decode caches, returns last-token logits)
# --------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg: ArchConfig, batch, cache_len: int,
            lengths: Optional[torch.Tensor] = None):
    """Inference prefill over the prompt.  Returns (last_logits (B,V),
    decode_state).

    ``lengths`` ((B,) int, optional) marks true per-row prompt lengths for
    right-padded batches: the logits are taken at position ``lengths-1``
    per row and the per-row KV ring layout keeps pad keys out of the cache.
    """
    _require_dense(cfg)
    spec = attn_spec(cfg)
    dtype = param_dtype(cfg)
    attn_len = _attn_len(cfg, cache_len)
    x, positions = embed_inputs(params, cfg, batch)
    ks, vs = [], []
    for layer in params["layers"]:
        h = L.norm_apply(cfg.norm, layer["norm1"], x)
        mix, (k, v) = L.attn_apply(layer["attn"], h, spec, positions,
                                   return_kv=True)
        cache = L.kv_to_cache(k, v, attn_len, dtype, lengths=lengths)
        ks.append(cache["k"])
        vs.append(cache["v"])
        x = _ffn(layer, cfg, x + mix)
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    if lengths is None:
        x_last = x[:, -1]
    else:
        last = (lengths.to(x.device).long() - 1).clamp(0, x.shape[1] - 1)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
    logits = logits_fn(params, cfg, x_last)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


# --------------------------------------------------------------------------
# decode (serve_step)
# --------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device=None) -> Dict[str, Any]:
    """Zeroed KV caches, ``{"k", "v"}`` of shape (n_layers, B, L, Kh, hd)."""
    _require_dense(cfg)
    device = resolve_device(device)
    caches = [L.kv_cache_init(batch, _attn_len(cfg, cache_len),
                              attn_spec(cfg), param_dtype(cfg), device)
              for _ in range(cfg.n_layers)]
    return {name: torch.stack([c[name] for c in caches])
            for name in ("k", "v")}


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, state, tokens, position):
    """One decode step.  tokens: (B,1) int; position: (B,) absolute.
    Returns (logits (B,V), state); ``state`` is updated in place."""
    _require_dense(cfg)
    spec = attn_spec(cfg)
    x = params["embed"]["w"][tokens.long()]                  # (B,1,d)
    for i, layer in enumerate(params["layers"]):
        h = L.norm_apply(cfg.norm, layer["norm1"], x)
        cache = {"k": state["k"][i], "v": state["v"][i]}
        mix, _ = L.attn_decode(layer["attn"], cache, h, spec, position)
        x = _ffn(layer, cfg, x + mix)
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    logits = logits_fn(params, cfg, x)
    return logits[:, 0, :], state


# --------------------------------------------------------------------------
# sampling head (serve steps return token ids, not logits)
# --------------------------------------------------------------------------
def sample_tokens(logits, generator: Optional[torch.Generator], temperature,
                  top_k, greedy_only: bool = False):
    """Per-row sampling over a (B,V) logits batch, on the logits' device.

    temperature: (B,) float — rows with temperature <= 0 decode greedily
    (argmax, first maximum); others sample from softmax(logits/temperature).
    top_k: (B,) int — rows with top_k > 0 keep only the k highest logits.
    ``generator`` draws the samples (the reference folds a JAX key per
    tick, so sampled tokens differ from it; greedy ones do not).
    ``greedy_only`` skips the sort and the draw when every row is greedy.
    Returns (B,) int32.
    """
    V = logits.shape[-1]
    lf = logits.float()
    greedy_tok = lf.argmax(dim=-1).to(torch.int32)
    if greedy_only:
        return greedy_tok
    scaled = lf / temperature.clamp_min(1e-6)[:, None]
    k = torch.where(top_k <= 0, V, top_k.clamp_max(V)).long()
    thresh = scaled.sort(dim=-1, descending=True).values.gather(
        -1, (k - 1)[:, None])
    scaled = scaled.masked_fill(scaled < thresh, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0.0, greedy_tok,
                       sampled.to(torch.int32))


def decode_and_sample(params, cfg: ArchConfig, state, tokens, position,
                      generator, temperature, top_k, greedy_only=False):
    """Fused decode + sample: only (B,) token ids need leave the device.
    Returns (sampled (B,) int32, state)."""
    logits, state = decode_step(params, cfg, state, tokens, position)
    return sample_tokens(logits, generator, temperature, top_k,
                         greedy_only=greedy_only), state


def prefill_and_sample(params, cfg: ArchConfig, batch, cache_len: int,
                       generator, temperature, top_k, lengths=None):
    """Fused prefill + first-token sample.  Returns ((B,) int32, state)."""
    logits, state = prefill(params, cfg, batch, cache_len=cache_len,
                            lengths=lengths)
    return sample_tokens(logits, generator, temperature, top_k), state

"""Model assembly: init, the training forward and loss, prefill, decode
and the sampling head.  Port of the text path of ``repro.models.model``
for the dense, ssm, moe and hybrid families.

The reference groups layers into repeating *periods* (``_slot_plan``: each
slot an attention or SSD mixer, followed by a dense MLP, an MoE FFN, an
MoE FFN plus a shared expert, or nothing), stacks each period's
parameters and scans over periods with ``jax.lax.scan``.  Here
``params["layers"]`` is a list of per-layer dicts, ``layers[p*P + j]``
being period p, slot j, and the stack is a Python loop; ``jax.checkpoint``
(remat) becomes one ``torch.utils.checkpoint.checkpoint`` per layer.  A
layer's keys say what it holds: ``attn`` or ``ssm``, then ``mlp``, or
``moe`` (plus ``shared_mlp``), or neither.  ``backbone`` returns the MoE
auxiliary loss summed over the layers, and ``train_loss`` adds it, as the
reference does.

The decode state is one flat dict: the KV caches ``{"k", "v"}``
(n_attn, B, L, Kh, hd) stacked over the attention layers and the SSM
states ``{"h": (n_ssm, B, nh, hp, N) f32, "conv": (n_ssm, B, W-1, C)}``
over the SSD layers, each layer indexing its own kind's axis in layer
order; :func:`decode_step` updates it in place (the reference donates
it).  The vlm and audio families raise ``NotImplementedError``.

An SSD layer with no FFN keeps ``norm2``, as the reference's slot does,
although nothing reads it; :func:`unused_leaves` marks those leaves, whose
gradient is zero.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.tree import tree_leaves, tree_map


# --------------------------------------------------------------------------
# structure helpers
# --------------------------------------------------------------------------
PORTED_FAMILIES = ("dense", "ssm", "moe", "hybrid")
# the decode state's keys for each mixer kind
STATE_KEYS = {"attn": ("k", "v"), "ssm": ("h", "conv")}


def require_ported(cfg: ArchConfig) -> None:
    """The text families are ported, with every slot plan they make; the
    vlm and audio frontends are not."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"runs {', '.join(PORTED_FAMILIES)} stacks")


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
    require_ported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = param_dtype(cfg)
    d = cfg.d_model
    g = generator
    plan = _slot_plan(cfg)
    embed = (torch.randn((cfg.vocab, d), generator=g, dtype=torch.float32,
                         device=device) * L.DEFAULT_INIT_SCALE).to(dtype)
    layers = []
    for i in range(cfg.n_layers):
        kind, has_moe, has_dense = plan[i % len(plan)]
        layer = {"norm1": L.norm_init(cfg.norm, d, dtype, device),
                 "norm2": L.norm_init(cfg.norm, d, dtype, device)}
        if kind == "attn":
            layer["attn"] = L.attn_init(g, d, attn_spec(cfg), dtype, device)
        else:
            layer["ssm"] = SSM.ssm_init(g, d, cfg.ssm, dtype, device)
        if has_moe:
            layer["moe"] = MOE.moe_init(g, d, cfg.moe, cfg.act, dtype,
                                        device)
            if cfg.moe.shared_expert:
                layer["shared_mlp"] = L.mlp_init(
                    g, d, cfg.d_ff or cfg.moe.expert_d_ff, cfg.act, dtype,
                    device)
        elif has_dense:
            layer["mlp"] = L.mlp_init(g, d, cfg.d_ff, cfg.act, dtype, device)
        layers.append(layer)
    params = {"embed": {"w": embed},
              "final_norm": L.norm_init(cfg.norm, d, dtype, device),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(g, d, cfg.vocab, dtype, device)
    return params


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------
def embed_inputs(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]):
    """Text inputs only.  Returns (x (B,S,d), positions (B,S), loss_mask
    (B,S) bool)."""
    require_ported(cfg)
    tokens = batch["tokens"]
    x = params["embed"]["w"][tokens.long()]
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    loss_mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    return x, positions, loss_mask


def _head_weight(params, cfg: ArchConfig):
    return (params["embed"]["w"].T if cfg.tie_embeddings
            else params["head"]["w"])


def _promote_matmul(x, w):
    """``x @ w`` in the promoted dtype of the two, as jnp's matmul does (a
    bf16 activation against an f32 head runs in f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def logits_fn(params, cfg: ArchConfig, x):
    return _promote_matmul(x, _head_weight(params, cfg))


def _ffn(layer, cfg: ArchConfig, x, token_mask=None):
    """The FFN after the mixer: a dense MLP, or the MoE (plus its shared
    expert), or nothing (an SSD layer's norm2 is then unread).  Returns
    (x, the MoE's aux loss or None)."""
    if "mlp" not in layer and "moe" not in layer:
        return x, None
    h = L.norm_apply(cfg.norm, layer["norm2"], x)
    if "mlp" in layer:
        return x + L.mlp_apply(layer["mlp"], h, cfg.act), None
    y, aux = MOE.moe_apply(layer["moe"], h, cfg.moe, cfg.act,
                           token_mask=token_mask)
    if "shared_mlp" in layer:
        y = y + L.mlp_apply(layer["shared_mlp"], h, cfg.act)
    return x + y, aux


def _layer_forward(layer, x, positions, cfg: ArchConfig, spec: L.AttnSpec):
    h = L.norm_apply(cfg.norm, layer["norm1"], x)
    if "ssm" in layer:
        mix = SSM.ssm_apply(layer["ssm"], h, cfg.ssm,
                            backend=cfg.mixer_backend)
    else:
        mix = L.attn_apply(layer["attn"], h, spec, positions)
    return _ffn(layer, cfg, x + mix)


def unused_leaves(params) -> List[bool]:
    """One flag per leaf of ``tree_leaves(params)``: True for the leaves no
    output reads (the norm2 of each SSD layer without an FFN), whose
    gradient is zero.  Differentiating only the others keeps autograd's
    check that every other parameter reaches the loss."""
    flags = tree_map(lambda _: False, params)
    for layer in flags["layers"]:
        if "ssm" in layer and "mlp" not in layer and "moe" not in layer:
            layer["norm2"] = tree_map(lambda _: True, layer["norm2"])
    return tree_leaves(flags)


def backbone(params, cfg: ArchConfig, x, positions, remat: bool = True):
    """The layer stack and the final norm.  Returns (x, aux): the MoE aux
    loss summed over the layers in layer order (f32 zero without MoE).
    With ``remat`` each layer is one ``checkpoint`` (the reference's
    ``nothing_saveable`` per period): only its input is kept, and its
    forward runs again in the backward pass."""
    require_ported(cfg)
    spec = attn_spec(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        if remat:
            # the layer draws no random numbers: no RNG state to keep
            x, a = checkpoint(_layer_forward, layer, x, positions, cfg, spec,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _layer_forward(layer, x, positions, cfg, spec)
        if a is not None:
            aux = aux + a
    return L.norm_apply(cfg.norm, params["final_norm"], x), aux


def forward(params, cfg: ArchConfig, batch, remat: bool = True):
    """Full forward -> logits (B,S,V) (the MoE aux loss is
    :func:`backbone`'s second output)."""
    x, positions, _ = embed_inputs(params, cfg, batch)
    x, _ = backbone(params, cfg, x, positions, remat=remat)
    return logits_fn(params, cfg, x)


# --------------------------------------------------------------------------
# loss (sequence-chunked cross entropy)
# --------------------------------------------------------------------------
def _xent_chunk(x, w, labels, mask):
    """x: (B,c,d); w: (d,V); labels: (B,c); mask: (B,c) f32.  The logits
    are taken in the operands' dtype and cast to f32 before logsumexp."""
    logits = _promote_matmul(x, w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def _as_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def cast_floating(tree, dtype):
    """Cast every floating-point tensor of ``tree`` (dicts and lists of
    tensors) to ``dtype``; other leaves pass through.  The cast is
    differentiable, so gradients return in the original dtype."""
    dtype = _as_dtype(dtype)
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floating(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def cast_compute_params(params, dtype):
    """Mixed-precision compute cast: the layers and the final norm go to
    ``dtype``; the embedding and the loss head stay in their master dtype
    (the vocab-sized matmuls feed logsumexp)."""
    out = dict(params)
    for key in ("layers", "final_norm"):
        if key in out:
            out[key] = cast_floating(out[key], dtype)
    return out


def train_loss(params, cfg: ArchConfig, batch, remat: bool = True,
               loss_chunk: int = 512, compute_dtype=None):
    """Scalar mean next-token cross entropy plus the MoE aux loss,
    sequence-chunked so the (B,S,V) logits are never materialised at once.

    ``compute_dtype`` (e.g. ``"bfloat16"``) runs the backbone in that
    dtype (see :func:`cast_compute_params`); the loss reduction stays f32.
    Must run with gradients enabled to be differentiated: unlike
    :func:`prefill` it is not under ``torch.no_grad()``.
    """
    if compute_dtype is not None:
        params = cast_compute_params(params, compute_dtype)
    x, positions, loss_mask = embed_inputs(params, cfg, batch)
    if compute_dtype is not None:
        x = x.to(_as_dtype(compute_dtype))
    x, aux = backbone(params, cfg, x, positions, remat=remat)
    w = _head_weight(params, cfg)

    # causal shift as in the reference: position t is scored against
    # labels[t + 1] (or tokens[t + 1] when the batch has no labels)
    xs = x[:, :-1]
    ls = (batch["labels"] if "labels" in batch else batch["tokens"])[:, 1:]
    ms = loss_mask[:, 1:].float()

    S = xs.shape[1]
    c = min(loss_chunk, S)
    n = S // c
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    bounds = [(i * c, (i + 1) * c) for i in range(n)]
    if S - n * c:
        bounds.append((n * c, S))
    for a, b in bounds:
        s, m = _xent_chunk(xs[:, a:b], w, ls[:, a:b], ms[:, a:b])
        tot, cnt = tot + s, cnt + m
    return tot / cnt.clamp_min(1.0) + aux


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
    per row, the per-row KV ring layout keeps pad keys out of the cache,
    SSM states are frozen at the last real token, and pad tokens claim no
    MoE capacity (the router's token mask).  Real tokens of co-batched
    rows still share one capacity pool, sized from the padded token
    count, as in the reference.
    """
    require_ported(cfg)
    spec = attn_spec(cfg)
    dtype = param_dtype(cfg)
    attn_len = _attn_len(cfg, cache_len)
    x, positions, _ = embed_inputs(params, cfg, batch)
    token_mask = None
    if lengths is not None:
        lengths = lengths.to(x.device)
        token_mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                      < lengths[:, None])
    states = {"attn": [], "ssm": []}
    for layer in params["layers"]:
        h = L.norm_apply(cfg.norm, layer["norm1"], x)
        if "ssm" in layer:
            mix, st = SSM.ssm_apply(layer["ssm"], h, cfg.ssm,
                                    return_state=True, seq_len=lengths,
                                    backend=cfg.mixer_backend)
            states["ssm"].append(st)
        else:
            mix, (k, v) = L.attn_apply(layer["attn"], h, spec, positions,
                                       return_kv=True)
            states["attn"].append(L.kv_to_cache(k, v, attn_len, dtype,
                                                lengths=lengths))
        x, _ = _ffn(layer, cfg, x + mix, token_mask)
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    if lengths is None:
        x_last = x[:, -1]
    else:
        last = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
    logits = logits_fn(params, cfg, x_last)
    return logits, {name: torch.stack([st[name] for st in sts])
                    for kind, sts in states.items() if sts
                    for name in STATE_KEYS[kind]}


# --------------------------------------------------------------------------
# decode (serve_step)
# --------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device=None) -> Dict[str, Any]:
    """Zeroed decode state: KV caches ``{"k", "v"}`` (n_attn, B, L, Kh, hd)
    over the attention layers and SSM states ``{"h", "conv"}`` (n_ssm,
    ...) over the SSD layers; a stack without one kind has no keys for
    it."""
    require_ported(cfg)
    device = resolve_device(device)
    kinds = cfg.layer_kinds()
    state = {}
    for kind, n in (("attn", kinds.count("attn")),
                    ("ssm", kinds.count("ssm"))):
        if not n:
            continue
        if kind == "ssm":
            one = SSM.ssm_state_init(batch, cfg.d_model, cfg.ssm,
                                     param_dtype(cfg), device)
        else:
            one = L.kv_cache_init(batch, _attn_len(cfg, cache_len),
                                  attn_spec(cfg), param_dtype(cfg), device)
        state.update({name: t[None].repeat((n,) + (1,) * t.dim())
                      for name, t in one.items()})
    return state


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, state, tokens, position):
    """One decode step.  tokens: (B,1) int; position: (B,) absolute.
    Returns (logits (B,V), state); ``state`` is updated in place.  The MoE
    routes with no token mask: every row, idle slots included, claims
    capacity, as in the reference."""
    require_ported(cfg)
    spec = attn_spec(cfg)
    x = params["embed"]["w"][tokens.long()]                  # (B,1,d)
    seen = {"attn": 0, "ssm": 0}           # each layer's index in its kind
    for layer, kind in zip(params["layers"], cfg.layer_kinds()):
        h = L.norm_apply(cfg.norm, layer["norm1"], x)
        own = {name: state[name][seen[kind]] for name in STATE_KEYS[kind]}
        seen[kind] += 1
        if kind == "ssm":
            mix, new = SSM.ssm_decode_step(layer["ssm"], own, h, cfg.ssm)
            for name, t in new.items():
                own[name].copy_(t)
        else:
            mix, _ = L.attn_decode(layer["attn"], own, h, spec, position)
        x, _ = _ffn(layer, cfg, x + mix)
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

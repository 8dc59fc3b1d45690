"""Model assembly: init, the training forward and loss, prefill, decode
and the sampling head.  Port of ``repro.models.model`` for every family:
the dense, ssm, moe and hybrid text stacks, the vlm (patch embeddings from
the frontend stub ahead of the token embeddings) and the encoder-only
audio family (frame embeddings in, masked prediction out, no decode).

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
it).

Under a parameter-sharded layout (``fsdp``, a
:class:`repro_torch.sharding.fsdp.FSDP`) the params are the rank's
shards: :func:`loss_terms`, :func:`forward`, :func:`prefill` and
:func:`decode_step` gather the embedding, head and final norm where they
are used and each layer's leaves inside its own (checkpointed) forward,
so the recompute of the backward gathers them again.  Each layer also
re-installs the :class:`repro_torch.sharding.ShardCtx` the backbone was
called under, which the recompute may run without.  No entry point of
the port installs a ctx yet (a data-grid step runs under none, see
:mod:`repro_torch.launch.steps`), so there the ctx is ``None``; only
direct callers (the tests) reach the grouped MoE dispatch and
``ssd_seq_parallel`` through it until the model-axis step installs one.

On a grid with a ``model`` axis (``fsdp_tp``) the storage carries a
:class:`repro_torch.sharding.tp.TP` (``fsdp.tp``) and every layer
computes on the rank's heads, experts, MLP columns and vocabulary rows
(:mod:`repro_torch.sharding.tp`): the embedding is a vocab-parallel
lookup where the rules split ``embed/w``'s vocabulary (the plain lookup
where they drop ``tp``), the loss a vocab-parallel cross entropy, and
:func:`prefill` and :func:`decode_step` return whole logits on every
rank.  The backbone hands each checkpointed layer the TP context as it
hands it the ctx, so the recompute takes the same groups.  The decode
state is the rules' block, as under ``fsdp_sp`` below: the prefill
reshards each layer's state from the rank's kv heads and ``[x, B, C]``
columns to its cache slots and conv channels (``TP.reshard_kv``,
``TP.reshard_conv``), and :func:`decode_step` runs attention and the SSD
step on those blocks, the token's q, k, v and ``[x, B, C]`` row gathered
from the ranks' heads.

Under ``fsdp_sp`` on a model axis the storage carries a
:class:`repro_torch.sharding.sp.SP` (``fsdp.sp``) instead, and the
sequence is split over the model ranks at the layer boundaries
(:mod:`repro_torch.sharding.sp`): :func:`embed_inputs` narrows x to the
rank's block after the embedding (a vlm's patches and tokens after
their concatenation; a sharded vocabulary's lookups reduce-scattered to
the blocks), the positions are the block's own, every layer computes on
the block, and the loss, :func:`forward` and :func:`prefill` gather the
final hidden state's sequence before the head.  The prefill returns the
rank's block of the decode state as the reference's
``decode_state_shardings`` splits it: the cache slots
``[m L/M, (m+1) L/M)``, the SSM heads and the conv channels of block
``m``.  An MoE FFN dispatches the block as one group and exchanges its
buffer with the experts' owners (:mod:`repro_torch.models.moe`), and the
loss averages the blocks' aux losses.  :func:`decode_step` runs on those
state blocks: its one token is replicated over the model axis, so the
lookup, the MLP, the experts and the head take ``fsdp_tp``'s forms on
their ``(fsdp, tp)`` blocks through the SP context (the vocabulary's
rows looked up and all-reduced, the partial sums all-reduced, the
logits' columns gathered), while attention and the SSD step run on the
rank's cache slots, heads and channels.

An SSD layer with no FFN keeps ``norm2``, as the reference's slot does,
although nothing reads it, and the audio family keeps an untied embedding
table that its frame inputs bypass; :func:`unused_leaves` marks those
leaves, whose gradient is zero.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import FAMILIES, ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.sharding.ctx import current_ctx, use_ctx
from repro_torch.sharding.sp import RAGGED_NEXT
from repro_torch.sharding.tp import state_shape
from repro_torch.tree import tree_leaves, tree_map


# --------------------------------------------------------------------------
# structure helpers
# --------------------------------------------------------------------------
# the decode state's keys for each mixer kind
STATE_KEYS = {"attn": ("k", "v"), "ssm": ("h", "conv")}


def require_decoder(cfg: ArchConfig) -> None:
    """An encoder-only config has no decode step (the reference's
    ``build_decode`` raises the same)."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")


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
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"known: {', '.join(FAMILIES)}")
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


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    allocation (the reference's ``param_specs``).  The draws come from a
    CPU generator: ``torch.Generator`` has no meta device."""
    return init_params(cfg, torch.Generator().manual_seed(0), device="meta")


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------
def _tp_of(fsdp):
    return None if fsdp is None else fsdp.tp


def _sp_of(fsdp):
    return None if fsdp is None else fsdp.sp


def _lookup(params, tokens, tp=None):
    """The token embeddings: vocab-parallel under ``tp`` where the
    embedding's vocabulary is split."""
    if tp is not None and tp.vocab.sharded:
        return tp.embed(params["embed"]["w"], tokens)
    return params["embed"]["w"][tokens.long()]


def embed_inputs(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                 tp=None, sp=None):
    """Returns (x (B,S,d), positions (B,S), loss_mask (B,S) bool).

    audio: the frame embeddings in the config's dtype, and the batch's
    mask.  vlm: the patch embeddings (in the config's dtype) ahead of the
    token embeddings, the loss masked off over the patches.  Text: the
    token embeddings.  Under ``sp`` x and the positions are the rank's
    block of the sequence, the loss mask the whole sequence's."""
    dtype = param_dtype(cfg)
    partial = (sp is not None and sp.vocab.sharded
               and cfg.family != "audio")
    if cfg.family == "audio":
        x = batch["features"].to(dtype)
    elif partial:
        # the rank's vocabulary rows' part of the whole sequence's lookup
        x = sp.vocab.lookup(params["embed"]["w"], batch["tokens"])
    else:
        x = _lookup(params, batch["tokens"], tp)
    if cfg.family == "vlm":
        patches = batch["patches"].to(dtype)
        if partial and sp.m:
            # the patches enter the reduce-scatter's sum once
            patches = torch.zeros_like(patches)
        # jnp.concatenate's promotion: bf16 patches, f32 tokens -> f32
        cat = torch.promote_types(patches.dtype, x.dtype)
        x = torch.cat([patches.to(cat), x.to(cat)], dim=1)
    if sp is not None:
        x = sp.scatter_seq(x) if partial else sp.narrow(x)
    B, S, _ = x.shape
    lo = 0 if sp is None else sp.block(S)[0]
    positions = torch.arange(lo, lo + S, device=x.device).expand(B, S)
    return x, positions, _loss_mask(cfg, batch)


def _loss_mask(cfg: ArchConfig, batch) -> torch.Tensor:
    """(B, S) bool over the model's input positions: audio's ``mask``;
    every token of a text batch; a vlm's tokens but not its patches."""
    if cfg.family == "audio":
        return batch["mask"]
    tokens = batch["tokens"]
    mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    if cfg.family == "vlm":
        mask = torch.cat([torch.zeros(batch["patches"].shape[:2],
                                      dtype=torch.bool, device=mask.device),
                          mask], dim=1)
    return mask


def _scored(cfg: ArchConfig, loss_mask: torch.Tensor) -> torch.Tensor:
    """The f32 mask of the positions the loss scores: audio scores each
    frame against its own label, the others position t against t + 1."""
    return (loss_mask if cfg.family == "audio" else loss_mask[:, 1:]).float()


def loss_count(cfg: ArchConfig, batch) -> torch.Tensor:
    """The f32 count of positions :func:`train_loss` scores on ``batch``
    (its ``cnt``), from the batch alone: a data-parallel step sums it over
    the ranks before its backward."""
    return _scored(cfg, _loss_mask(cfg, batch)).sum()


def _head_weight(params, cfg: ArchConfig):
    return (params["embed"]["w"].T if cfg.tie_embeddings
            else params["head"]["w"])


def _promote_matmul(x, w):
    """``x @ w`` in the promoted dtype of the two, as jnp's matmul does (a
    bf16 activation against an f32 head runs in f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _vocab_of(tp, sp):
    """The model axis's :class:`repro_torch.sharding.tp.Vocab` where it
    splits the vocabulary, else None."""
    par = tp or sp
    return None if par is None or not par.vocab.sharded else par.vocab


def _enter(x, tp):
    """``x`` entering a tensor-parallel region (under ``sp`` it is the
    whole sequence's, whose ``gather_seq`` backward sums the shards'
    partial gradients already)."""
    return x if tp is None else tp.enter(x)


def logits_fn(params, cfg: ArchConfig, x, tp=None, sp=None):
    """Whole logits; under ``tp`` or ``sp`` (whose x is the whole
    sequence) with a split vocabulary each rank's columns, gathered."""
    vocab = _vocab_of(tp, sp)
    if vocab is not None:
        return vocab.gather(_promote_matmul(_enter(x, tp),
                                            _head_weight(params, cfg)))
    return _promote_matmul(x, _head_weight(params, cfg))


def _ffn(layer, cfg: ArchConfig, x, token_mask=None, tp=None, sp=None):
    """The FFN after the mixer: a dense MLP, or the MoE (plus its shared
    expert), or nothing (an SSD layer's norm2 is then unread).  Returns
    (x, the MoE's aux loss or None)."""
    if "mlp" not in layer and "moe" not in layer:
        return x, None
    h = L.norm_apply(cfg.norm, layer["norm2"], x)
    if "mlp" in layer:
        return x + L.mlp_apply(layer["mlp"], h, cfg.act, tp, sp), None
    y, aux = MOE.moe_apply(layer["moe"], h, cfg.moe, cfg.act,
                           token_mask=token_mask, tp=tp, sp=sp)
    if "shared_mlp" in layer:
        y = y + L.mlp_apply(layer["shared_mlp"], h, cfg.act, tp, sp)
    return x + y, aux


def _layer_forward(layer, x, positions, cfg: ArchConfig, spec: L.AttnSpec,
                   ctx=None, gather=None, tp=None, sp=None):
    """One layer; ``ctx`` is installed around it, ``gather`` (an FSDP
    layer gather) turns its shards into its model blocks first, and
    ``tp`` (a :class:`repro_torch.sharding.tp.TP`) computes on them, or
    ``sp`` (a :class:`repro_torch.sharding.sp.SP`) on the rank's block
    of the sequence."""
    with use_ctx(ctx):
        if gather is not None:
            layer = gather(layer)
        h = L.norm_apply(cfg.norm, layer["norm1"], x)
        if "ssm" in layer:
            mix = SSM.ssm_apply(layer["ssm"], h, cfg.ssm,
                                backend=cfg.mixer_backend, tp=tp, sp=sp)
        else:
            mix = L.attn_apply(layer["attn"], h, spec, positions, tp=tp,
                               sp=sp)
        return _ffn(layer, cfg, x + mix, tp=tp, sp=sp)


def _unused_outer(cfg: ArchConfig) -> tuple:
    """Top-level params no output reads (see :func:`unused_leaves`): an
    FSDP step does not gather them."""
    return ("embed",) if cfg.family == "audio" and not cfg.tie_embeddings \
        else ()


def _gather_outer(params, cfg: ArchConfig, fsdp):
    return params if fsdp is None else fsdp.gather_outer(
        params, skip=_unused_outer(cfg))


def unused_leaves(params, cfg: ArchConfig) -> List[bool]:
    """One flag per leaf of ``tree_leaves(params)``: True for the leaves no
    output reads (the norm2 of each SSD layer without an FFN; the audio
    family's untied embedding table, which its frame inputs bypass),
    whose gradient is zero.  Differentiating only the others keeps
    autograd's check that every other parameter reaches the loss."""
    flags = tree_map(lambda _: False, params)
    for key in _unused_outer(cfg):
        flags[key] = tree_map(lambda _: True, flags[key])
    for layer in flags["layers"]:
        if "ssm" in layer and "mlp" not in layer and "moe" not in layer:
            layer["norm2"] = tree_map(lambda _: True, layer["norm2"])
    return tree_leaves(flags)


def backbone(params, cfg: ArchConfig, x, positions, remat: bool = True,
             fsdp=None):
    """The layer stack and the final norm.  Returns (x, aux): the MoE aux
    loss summed over the layers in layer order (f32 zero without MoE).
    With ``remat`` each layer is one ``checkpoint`` (the reference's
    ``nothing_saveable`` per period): only its input is kept, and its
    forward (its FSDP gathers too) runs again in the backward pass.
    ``params["final_norm"]`` must be whole (see :func:`_gather_outer`)."""
    spec = attn_spec(cfg)
    ctx = current_ctx()
    tp, sp = _tp_of(fsdp), _sp_of(fsdp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params["layers"]):
        gather = None if fsdp is None else fsdp.layer_gather(i)
        if remat:
            # the layer draws no random numbers: no RNG state to keep
            x, a = checkpoint(_layer_forward, layer, x, positions, cfg, spec,
                              ctx, gather, tp, sp, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _layer_forward(layer, x, positions, cfg, spec, ctx,
                                  gather, tp, sp)
        if a is not None:
            aux = aux + a
    return L.norm_apply(cfg.norm, params["final_norm"], x), aux


def forward(params, cfg: ArchConfig, batch, remat: bool = True, fsdp=None):
    """Full forward -> logits (B,S,V) (the MoE aux loss is
    :func:`backbone`'s second output).  Under ``fsdp.sp`` the whole
    sequence's logits on every rank (for inference: a replicated head's
    gradient would be counted once a rank)."""
    params = _gather_outer(params, cfg, fsdp)
    tp, sp = _tp_of(fsdp), _sp_of(fsdp)
    x, positions, _ = embed_inputs(params, cfg, batch, tp, sp)
    x, _ = backbone(params, cfg, x, positions, remat=remat, fsdp=fsdp)
    if sp is not None:
        x = sp.gather_seq(x)
    return logits_fn(params, cfg, x, tp, sp)


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
               loss_chunk: int = 512, compute_dtype=None, fsdp=None):
    """Scalar mean cross entropy plus the MoE aux loss, sequence-chunked
    so the (B,S,V) logits are never materialised at once: next-token
    prediction for the text and vlm families, masked prediction of every
    frame's label for audio.

    ``compute_dtype`` (e.g. ``"bfloat16"``) runs the backbone in that
    dtype (see :func:`cast_compute_params`); the loss reduction stays f32.
    Must run with gradients enabled to be differentiated: unlike
    :func:`prefill` it is not under ``torch.no_grad()``.
    """
    tot, cnt, aux = loss_terms(params, cfg, batch, remat=remat,
                               loss_chunk=loss_chunk,
                               compute_dtype=compute_dtype, fsdp=fsdp)
    return tot / cnt.clamp_min(1.0) + aux


def loss_terms(params, cfg: ArchConfig, batch, remat: bool = True,
               loss_chunk: int = 512, compute_dtype=None, fsdp=None):
    """:func:`train_loss`'s parts ``(tot, cnt, aux)``: the f32 sum of the
    scored positions' cross entropy, their count and the MoE aux loss.
    The loss is ``tot / max(cnt, 1) + aux``; a data-parallel rank divides
    its ``tot`` by the count summed over every rank instead.  Under
    ``fsdp.sp`` both are the whole sequence's on every model rank: the
    final hidden state's sequence is gathered for a sharded vocabulary's
    head, and a replicated head scores the rank's block and all-reduces
    its sums."""
    if compute_dtype is not None:
        params = cast_compute_params(params, compute_dtype)
    params = _gather_outer(params, cfg, fsdp)
    tp, sp = _tp_of(fsdp), _sp_of(fsdp)
    x, positions, loss_mask = embed_inputs(params, cfg, batch, tp, sp)
    if compute_dtype is not None:
        x = x.to(_as_dtype(compute_dtype))
    x, aux = backbone(params, cfg, x, positions, remat=remat, fsdp=fsdp)
    w = _head_weight(params, cfg)
    vocab = _vocab_of(tp, sp)
    # under sp a replicated head scores the rank's block, from lo on
    lo = None if sp is None or sp.vocab.sharded else sp.block(x.shape[1])[0]
    if sp is not None and lo is None:
        x = sp.gather_seq(x)
    if vocab is None:
        xent = _xent_chunk
    else:
        # the head is the rank's vocabulary columns
        x = _enter(x, tp)

        def xent(xc, wc, labels, mask):
            return vocab.xent_chunk(_promote_matmul(xc, wc).float(), labels,
                                    mask)

    if cfg.family == "audio":
        # no shift: each frame is scored against its own label where the
        # mask says so
        xs, ls = x, batch["labels"]
    else:
        # causal shift as in the reference: position t is scored against
        # labels[t + 1] (or tokens[t + 1] when the batch has no labels);
        # a vlm's tokens are padded on the left over the patches, so the
        # last patch position scores the first text token
        xs = x[:, :-1]
        if "labels" in batch:
            full = batch["labels"]
        else:
            full = batch["tokens"]
            if cfg.family == "vlm":
                P = batch["patches"].shape[1]
                full = torch.cat([full.new_zeros((full.shape[0], P)), full],
                                 dim=1)
        ls = full[:, 1:]
    ms = _scored(cfg, loss_mask)
    if lo is not None:
        # the block's scored positions: the last one has no next token
        hi = min(lo + x.shape[1], ls.shape[1])
        xs, ls, ms = x[:, :hi - lo], ls[:, lo:hi], ms[:, lo:hi]

    if sp is not None and cfg.moe is not None:
        # the mean of the blocks' aux losses (each block one dispatch
        # group), whole on every rank; each rank's gradient flows to its
        # own block's
        aux = sp.vocab.exit(aux) / sp.M
    S = xs.shape[1]
    c = min(loss_chunk, S)
    n = S // c
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    bounds = [(i * c, (i + 1) * c) for i in range(n)]
    if S - n * c:
        bounds.append((n * c, S))
    for a, b in bounds:
        s, m = xent(xs[:, a:b], w, ls[:, a:b], ms[:, a:b])
        tot, cnt = tot + s, cnt + m
    if lo is not None:
        # the blocks' sums, whole on every rank; each rank's gradient
        # flows back to its own block
        tot, cnt = sp.vocab.exit(tot), sp.vocab.exit(cnt)
    return tot, cnt, aux


# --------------------------------------------------------------------------
# prefill (fills the decode caches, returns last-token logits)
# --------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg: ArchConfig, batch, cache_len: int,
            lengths: Optional[torch.Tensor] = None, fsdp=None):
    """Inference prefill over the prompt (a vlm's patches, then its
    tokens).  Returns (last_logits (B,V), decode_state).

    ``lengths`` ((B,) int, optional) marks true per-row prompt lengths for
    right-padded batches: the logits are taken at position ``lengths-1``
    per row, the per-row KV ring layout keeps pad keys out of the cache,
    SSM states are frozen at the last real token, and pad tokens claim no
    MoE capacity (the router's token mask).  Real tokens of co-batched
    rows still share one capacity pool, sized from the padded token
    count, as in the reference.  A vlm batch's ``lengths`` count its
    patches too.  Under ``fsdp.sp`` the logits are whole on every rank
    and the decode state is the rank's block of it (no ``lengths``).
    """
    spec = attn_spec(cfg)
    dtype = param_dtype(cfg)
    attn_len = _attn_len(cfg, cache_len)
    params = _gather_outer(params, cfg, fsdp)
    tp, sp = _tp_of(fsdp), _sp_of(fsdp)
    if sp is not None and lengths is not None:
        raise NotImplementedError(RAGGED_NEXT)
    x, positions, _ = embed_inputs(params, cfg, batch, tp, sp)
    token_mask = None
    if lengths is not None:
        lengths = lengths.to(x.device)
        token_mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                      < lengths[:, None])
    states = {"attn": [], "ssm": []}
    for i, layer in enumerate(params["layers"]):
        if fsdp is not None:
            layer = fsdp.layer_gather(i)(layer)
        h = L.norm_apply(cfg.norm, layer["norm1"], x)
        if "ssm" in layer:
            mix, st = SSM.ssm_apply(layer["ssm"], h, cfg.ssm,
                                    return_state=True, seq_len=lengths,
                                    backend=cfg.mixer_backend, tp=tp, sp=sp)
        else:
            mix, (k, v) = L.attn_apply(layer["attn"], h, spec, positions,
                                       return_kv=True, tp=tp, sp=sp)
            st = L.kv_to_cache(k, v, attn_len, dtype, lengths=lengths)
        if sp is not None:
            st = {name: sp.state_block(name, t) for name, t in st.items()}
        elif tp is not None:
            st = _reshard(st, cfg, tp)
        states["ssm" if "ssm" in layer else "attn"].append(st)
        x, _ = _ffn(layer, cfg, x + mix, token_mask, tp, sp)
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    if sp is not None:
        x = sp.gather_seq(x)
    if lengths is None:
        x_last = x[:, -1]
    else:
        last = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
    logits = logits_fn(params, cfg, x_last, tp, sp)
    return logits, {name: torch.stack([st[name] for st in sts])
                    for kind, sts in states.items() if sts
                    for name in STATE_KEYS[kind]}


def _reshard(st: dict, cfg: ArchConfig, tp) -> dict:
    """One layer's prefill state under ``fsdp_tp``, from what the rank
    computed (its kv heads' K/V over every slot; its SSM heads' ``h`` and
    its ``[x, B, C]`` columns' conv rows) to the rules' block: every kv
    head over the rank's slots, its heads' ``h`` as it is, its channel
    block of ``conv`` (``state_reshard``)."""
    if "k" in st:
        k, v = tp.reshard_kv(st["k"], st["v"])
        return {"k": k, "v": v}
    return {"h": st["h"], "conv": tp.reshard_conv(st["conv"], cfg.ssm)}


# --------------------------------------------------------------------------
# decode (serve_step)
# --------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device=None, grid=None,
                      layout: str = "fsdp_tp") -> Dict[str, Any]:
    """Zeroed decode state: KV caches ``{"k", "v"}`` (n_attn, B, L, Kh, hd)
    over the attention layers and SSM states ``{"h", "conv"}`` (n_ssm,
    ...) over the SSD layers; a stack without one kind has no keys for
    it.  On a ``grid`` with a ``model`` axis (``fsdp_tp`` or
    ``fsdp_sp``), the rank's blocks as ``rules.decode_state_shardings``
    splits them: its ``L/M`` cache slots of every kv head, ``nh/M`` SSM
    heads and ``C/M`` conv channels (whole where ``M`` does not divide).
    An encoder-only config has none and raises ``ValueError``."""
    require_decoder(cfg)
    device = resolve_device(device)
    spec = attn_spec(cfg)
    M = 1 if grid is None or layout == "dp" else grid.extent("model")
    kinds = cfg.layer_kinds()
    state = {}
    for kind, n in (("attn", kinds.count("attn")),
                    ("ssm", kinds.count("ssm"))):
        if not n:
            continue
        if kind == "ssm":
            one = SSM.ssm_state_init(batch, cfg.d_model, cfg.ssm,
                                     param_dtype(cfg), "meta")
        else:
            one = L.kv_cache_init(batch, _attn_len(cfg, cache_len), spec,
                                  param_dtype(cfg), "meta")
        for name, t in one.items():
            shape = state_shape(name, t.shape, M)
            state[name] = torch.zeros((n,) + tuple(shape), dtype=t.dtype,
                                      device=device)
    return state


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, state, tokens, position,
                fsdp=None, cache_len: Optional[int] = None):
    """One decode step.  tokens: (B,1) int; position: (B,) absolute.
    Returns (logits (B,V), state); ``state`` is updated in place.  The MoE
    routes with no token mask: every row, idle slots included, claims
    capacity, as in the reference.  An encoder-only config raises
    ``ValueError``.  On a model axis (``fsdp.tp`` or ``fsdp.sp``) the
    state is the rank's blocks and ``cache_len`` (the cache's whole
    length, which a block does not show) is required for attention."""
    require_decoder(cfg)
    spec = attn_spec(cfg)
    params = _gather_outer(params, cfg, fsdp)
    tp, sp = _tp_of(fsdp), _sp_of(fsdp)
    # the token is replicated over the model axis: under sp the lookup,
    # the FFN and the head take the tensor-parallel forms too
    axis = tp if sp is None else sp
    attn_len = None if cache_len is None else _attn_len(cfg, cache_len)
    x = _lookup(params, tokens, axis)                        # (B,1,d)
    seen = {"attn": 0, "ssm": 0}           # each layer's index in its kind
    for i, (layer, kind) in enumerate(zip(params["layers"],
                                          cfg.layer_kinds())):
        if fsdp is not None:
            layer = fsdp.layer_gather(i)(layer)
        h = L.norm_apply(cfg.norm, layer["norm1"], x)
        own = {name: state[name][seen[kind]] for name in STATE_KEYS[kind]}
        seen[kind] += 1
        if kind == "ssm":
            mix, new = SSM.ssm_decode_step(layer["ssm"], own, h, cfg.ssm,
                                           tp, sp)
            for name, t in new.items():
                own[name].copy_(t)
        else:
            mix, _ = L.attn_decode(layer["attn"], own, h, spec, position,
                                   tp, sp, attn_len)
        x, _ = _ffn(layer, cfg, x + mix, tp=axis)
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    logits = logits_fn(params, cfg, x, axis)
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

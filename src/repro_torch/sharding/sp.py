"""Sequence parallelism over the grid's ``model`` axis (``fsdp_sp``).

Storage follows the reference's rules (:mod:`repro_torch.sharding.fsdp`):
the attention and SSM projections, ``conv_w``, ``conv_b`` and
``norm_scale`` are split over both axes (``fsdp2``) and gathered whole
where a layer runs; the MLP and the vocabulary keep ``fsdp_tp``'s
``(fsdp, tp)`` blocks, and the experts their ``tp`` blocks (rank ``m``
holds experts ``[m E/M, (m+1) E/M)``).  Compute follows the reference's
activations (``logical_axes``): the **sequence** is split over ``model``
at the layer boundaries, so rank ``m`` of ``M`` holds positions
``[m S/M, (m+1) S/M)`` of its data row's rows, and

* attention computes q, k and v on the rank's rows with the whole
  weights, applies RoPE at their absolute positions and all-gathers K
  and V at kv-head width (:meth:`SP.gather_kv`, ``kv_allgather``; the
  backward reduce-scatters dK and dV to their owners); K1-K3 run the
  block's queries against the gathered keys at ``q_offset = m S/M``;
* the SSD mixer runs K4 on the rank's segment from a zero state, the
  segments' final states and decays are all-gathered
  (:meth:`SP.exchange_states`, ``ssd_state_allgather``) and each rank
  adds the correction of its incoming state; the causal conv takes the
  previous rank's last ``W - 1`` inputs (:meth:`SP.halo`,
  ``conv_halo``).  A block shorter than the chunk (or the conv's
  ``W - 1`` rows) takes the reference's fallback instead: the mixer's
  input gathered (``gather_seq``), the whole sequence's scan, the
  rank's block of its output;
* the MLP is Megatron's sequence-parallel trade on its column and row
  blocks: :meth:`SP.gather_seq` before ``up``/``gate`` (an all-gather
  forward, a reduce-scatter backward: ``sp_allgather``) and
  :meth:`SP.scatter_seq` after ``down`` (a reduce-scatter of the partial
  sums forward, an all-gather backward: ``sp_reducescatter``);
* an MoE FFN dispatches the rank's block as one group (the reference's
  ``_dispatch_groups`` at ``gs = M``): routing, ranks and the capacity
  scatter stay local, the ``(E, C, d)`` buffer crosses to the experts'
  owners in one all-to-all (:meth:`SP.exchange_experts`,
  ``moe_alltoall``; its backward the reverse all-to-all), each rank runs
  its experts on every group's slots, and the outputs cross back for a
  local combine.  The aux loss is the mean of the blocks' (an
  all-reduce of the step's sum, in the loss);
* a sharded vocabulary looks up the whole sequence in the rank's rows
  (:meth:`Vocab.lookup`'s masking) and ``scatter_seq`` leaves each rank
  its block summed over the vocabulary shards; the step's inputs arrive
  whole on every rank of a data row, so the ids need no gather.  The
  head takes the whole sequence (``gather_seq`` of the final hidden
  state, whose backward already sums the vocabulary shards' partial
  gradients) and :meth:`Vocab.xent_chunk`'s vocab-parallel cross
  entropy, unchanged, which keeps the causal shift across block
  boundaries exact.  Where the rules replicate the vocabulary (a
  vocabulary ``M`` does not divide) the lookup and the loss run on the
  rank's block and the loss's sums are all-reduced (:meth:`Vocab.exit`).

Decode's one token is replicated over the axis, and the decode state is
split as ``rules.decode_state_shardings`` splits it (kept whole where
``M`` does not divide the dim): the cache slots, the SSM heads, the
conv's ``[x, B, C]`` channels.  So attention writes the new key and
value only on the rank that owns its slot, scores q against the rank's
slots and combines the ranks' row max, sum and P·V (one all-gather,
:meth:`ModelAxis.combine_softmax`, ``softmax_combine``: a distributed
softmax, shared with ``fsdp_tp``);
the SSD step convolves the rank's channels and all-gathers the post-conv
row (:meth:`ModelAxis.gather_channels`, ``conv_allgather``), then runs the
rank's heads; and the MLP, the experts and the vocabulary take
``fsdp_tp``'s forms on their blocks, through :class:`SP`'s
:class:`repro_torch.sharding.tp.ModelAxis` operators (partial sums
all-reduced, ``tp_allreduce``; the logits' columns gathered).

:class:`SP` holds the vocabulary's rows and collectives as a
:class:`repro_torch.sharding.tp.Vocab`, which :class:`repro_torch.
sharding.tp.TP` holds too.  A prefill with ragged ``lengths`` raises
(:data:`RAGGED_NEXT`): the reference's sharded ``build_prefill`` passes
none.  :func:`sp_bytes` counts a step's bytes by mechanism from the
shapes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding.tp import ModelAxis, Plan, Vocab, _evenly, _split

RAGGED_NEXT = ("fsdp_sp's prefill takes no ragged lengths (the reference's "
               "sharded build_prefill passes none)")
# every mechanism sp_bytes counts
MECHANISMS = ("kv_allgather", "sp_allgather", "sp_reducescatter",
              "conv_halo", "ssd_state_allgather", "moe_alltoall",
              "softmax_combine", "conv_allgather", "tp_allreduce",
              "vocab_allgather")


def check_config(cfg, seq: int, M: int) -> None:
    """Raise unless ``M`` splits a sequence of ``seq`` into equal
    blocks."""
    if seq % M:
        raise ValueError(f"{cfg.name}: a sequence of {seq} does not split "
                         f"into {M} blocks")


def short_block(cfg, block: int) -> bool:
    """Whether an SSD layer takes the whole-sequence fallback at a
    sequence block of ``block``: shorter than the chunk, or than the
    conv's ``W - 1`` halo rows."""
    return block < cfg.chunk or block < cfg.conv_width - 1


# --------------------------------------------------------------------------
# the operators
# --------------------------------------------------------------------------
class _AllGather(torch.autograd.Function):
    """All-gather along ``dim`` over the model group forward, the
    gradient reduce-scattered backward, both under ``mechanism``."""

    @staticmethod
    def forward(ctx, x, dim, sp, mechanism):
        ctx.dim, ctx.sp, ctx.mechanism = dim, sp, mechanism
        return sp.dist.all_gather(x, dim, mechanism, sp.group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return (ctx.sp.dist.reduce_scatter(grad, ctx.dim, ctx.mechanism,
                                           ctx.sp.group).contiguous(),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    """Partial sums reduce-scattered along ``dim`` forward (each rank its
    block of the sum), the gradient all-gathered backward."""

    @staticmethod
    def forward(ctx, x, dim, sp, mechanism):
        ctx.dim, ctx.sp, ctx.mechanism = dim, sp, mechanism
        return sp.dist.reduce_scatter(x, dim, mechanism,
                                      sp.group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return (ctx.sp.dist.all_gather(grad, ctx.dim, ctx.mechanism,
                                       ctx.sp.group).contiguous(),
                None, None, None)


class _Halo(torch.autograd.Function):
    """Every rank's last ``W - 1`` conv-input rows all-gathered: returns
    the previous rank's (zeros on rank 0, as the world-1 conv pads) and
    the last rank's (the prefill's conv state).  The backward
    reduce-scatters each rank's gradient to the rows' owner."""

    @staticmethod
    def forward(ctx, rows, sp):
        ctx.sp = sp
        got = sp.dist.all_gather(rows[None], 0, "conv_halo", sp.group)
        prev = got[sp.m - 1] if sp.m else torch.zeros_like(rows)
        return prev.contiguous(), got[sp.M - 1].contiguous()

    @staticmethod
    def backward(ctx, g_prev, g_last):
        sp = ctx.sp
        full = g_last.new_zeros((sp.M,) + tuple(g_last.shape))
        full[sp.M - 1] = g_last
        if sp.m:
            full[sp.m - 1] += g_prev
        return (sp.dist.reduce_scatter(full, 0, "conv_halo", sp.group)[0],
                None)


def _combine(got: torch.Tensor, shape, m: int):
    """The incoming state of segment ``m`` and the final state from the
    segments' packed ``(M, B, nh*hp*N + nh)`` f32 states and decays, in
    the order of the world-1 segment scan."""
    B, nh, hp, N = shape
    n = nh * hp * N
    hs = got[..., :n].reshape((got.shape[0],) + tuple(shape))
    ds = got[..., n:]
    h = torch.zeros_like(hs[0])
    h_in = h
    for s in range(got.shape[0]):
        if s == m:
            h_in = h
        h = ds[s][..., None, None] * h + hs[s]
    return h_in, h


class _Exchange(torch.autograd.Function):
    """Each rank's SSD segment state ``(B, nh, hp, N)`` f32 and decay
    ``(B, nh)`` all-gathered in one f32 buffer; returns the rank's
    incoming state and the final state, combined over the segments.  The
    backward differentiates the combine on the gathered states and
    reduce-scatters the result to each segment's owner."""

    @staticmethod
    def forward(ctx, h, decay, sp):
        packed = torch.cat([h.flatten(1), decay], dim=1)
        got = sp.dist.all_gather(packed[None], 0, "ssd_state_allgather",
                                 sp.group)
        ctx.save_for_backward(got)
        ctx.sp, ctx.shape = sp, tuple(h.shape)
        return _combine(got, ctx.shape, sp.m)

    @staticmethod
    def backward(ctx, g_in, g_final):
        (got,) = ctx.saved_tensors
        sp = ctx.sp
        with torch.enable_grad():
            leaf = got.detach().requires_grad_(True)
            outs = [(o, g) for o, g in zip(_combine(leaf, ctx.shape, sp.m),
                                           (g_in, g_final))
                    if o.requires_grad]
            (full,) = torch.autograd.grad([o for o, _ in outs],
                                          [leaf], [g for _, g in outs])
        mine = sp.dist.reduce_scatter(full, 0, "ssd_state_allgather",
                                      sp.group)[0]
        n = mine.shape[1] - ctx.shape[1]
        return mine[:, :n].reshape(ctx.shape), mine[:, n:], None


class _AllToAll(torch.autograd.Function):
    """The experts' exchange: dim 0's ``M`` blocks sent to their ranks
    forward, the gradient's sent back the same way (an all-to-all of
    equal blocks is its own transpose), both ``moe_alltoall``."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return sp.dist.all_to_all(x, "moe_alltoall", sp.group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.sp.dist.all_to_all(grad, "moe_alltoall",
                                      ctx.sp.group), None


# --------------------------------------------------------------------------
class SP(ModelAxis):
    """A rank's sequence-parallel context on ``grid``'s model axis for
    the arch ``cfg``: its model group, its coordinate ``m`` of ``M``, its
    experts (``plan.experts``) and its :class:`repro_torch.sharding.tp.
    Vocab`; as a :class:`repro_torch.sharding.tp.ModelAxis`, the
    operators a decode step's replicated token takes."""

    def __init__(self, grid, cfg):
        super().__init__(grid)
        if cfg.d_ff:
            _evenly(cfg.name, cfg.d_ff, self.M, "d_ff")
        experts = None
        if cfg.moe is not None:
            _evenly(cfg.name, cfg.moe.n_experts, self.M, "n_experts")
            experts = _split(cfg.moe.n_experts, self.M, self.m)
            if cfg.moe.shared_expert:
                _evenly(cfg.name, cfg.d_ff or cfg.moe.expert_d_ff, self.M,
                        "the shared expert's d_ff")
        rows = (_split(cfg.vocab, self.M, self.m) if cfg.vocab % self.M == 0
                else None)
        self.plan = Plan(self.M, self.m, experts=experts, vocab=rows)
        self.vocab = Vocab(self.dist, self.group, self.M, self.m, rows)

    # --------------------------------------------------------- sequence
    def block(self, local: int) -> Tuple[int, int]:
        """``(first position, whole length)`` of the rank's block of
        ``local`` tokens."""
        return self.m * local, self.M * local

    def narrow(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's block of a whole-sequence tensor."""
        S = x.shape[dim]
        if S % self.M:
            raise ValueError(f"a sequence of {S} does not split into "
                             f"{self.M} blocks")
        return x.narrow(dim, self.m * (S // self.M), S // self.M)

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from the ranks' blocks (``sp_allgather``)."""
        return _AllGather.apply(x, dim, self, "sp_allgather")

    def scatter_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's block of the ranks' whole-sequence partial sums
        (``sp_reducescatter``)."""
        return _ReduceScatter.apply(x, dim, self, "sp_reducescatter")

    def gather_kv(self, k: torch.Tensor, v: torch.Tensor):
        """K and V (B, S/M, Kh, hd) of every block, after RoPE, as
        (B, S, Kh, hd) each: one all-gather (``kv_allgather``)."""
        both = _AllGather.apply(torch.stack([k, v]), 2, self,
                                "kv_allgather")
        return both[0], both[1]

    def halo(self, rows: torch.Tensor):
        """``(previous rank's rows, last rank's rows)`` of the ranks'
        last ``W - 1`` conv inputs ``rows`` (B, W-1, C) (``conv_halo``)."""
        return _Halo.apply(rows, self)

    def exchange_states(self, h: torch.Tensor, decay: torch.Tensor):
        """``(incoming state, final state)`` of the rank's SSD segment
        from every segment's state ``h`` (B, nh, hp, N) f32 and decay
        (B, nh) f32 (``ssd_state_allgather``)."""
        return _Exchange.apply(h.float(), decay.float(), self)

    def exchange_experts(self, buf: torch.Tensor) -> torch.Tensor:
        """The experts' all-to-all (``moe_alltoall``): ``buf``'s dim 0 in
        ``M`` blocks, block ``j`` for rank ``j``'s experts; returns the
        blocks the ranks sent this one, in rank order."""
        return _AllToAll.apply(buf, self)


# --------------------------------------------------------------------------
# the shape count
# --------------------------------------------------------------------------
def sp_bytes(cfg, batch: int, seq: int, kind: str, M: int, act_bytes: int,
             embed_bytes: Optional[int] = None) -> Dict[str, float]:
    """A rank's bytes by mechanism (:data:`MECHANISMS`) in one ``fsdp_sp``
    step of ``kind`` on a model axis of ``M``, in the ring convention (a
    gather, reduce-scatter or all-to-all of F whole bytes moves ``(M-1)/M
    F`` a rank, an all-reduce twice that): train or prefill over
    ``batch`` rows of ``seq`` tokens (the whole sequence of its data row;
    a vlm's patches included), or one decode step of ``batch`` rows over
    a cache of ``seq`` slots (:func:`_decode_bytes`).  Activations are
    ``act_bytes`` an element, the embedding's lookups ``embed_bytes``
    (default: the same); states, decays, softmax partials and the loss's
    terms are f32, and the logits in the activations' dtype.
    Training runs each layer's forward twice (remat) and its backward
    once; the recompute stops after the last op that saves a tensor, so
    it skips each MLP's ``scatter_seq`` (the experts' combine saves its
    inputs, so both all-to-alls run again).  The FSDP gathers and
    reductions are not counted here (:mod:`repro_torch.analysis.
    analytic`)."""
    out = dict.fromkeys(MECHANISMS, 0.0)
    if M == 1:
        return out
    embed_bytes = act_bytes if embed_bytes is None else embed_bytes
    if kind == "decode":
        return _decode_bytes(out, cfg, batch, seq, M, act_bytes,
                             embed_bytes)
    if kind not in ("train", "prefill"):
        raise ValueError(f"unknown step kind {kind!r}")
    # imported here: the models import this module
    from repro_torch.models.moe import capacity_of
    f = (M - 1) / M
    train = kind == "train"
    passes = 3 if train else 1          # forward, recompute, backward
    T, d = batch * seq, cfg.d_model
    x = T * d * act_bytes * f
    moe = _moe_mask(cfg)
    for kind_l, has_moe in zip(cfg.layer_kinds(), moe):
        if kind_l == "attn":
            kv = 2 * T * cfg.n_kv_heads * cfg.head_dim * act_bytes * f
            out["kv_allgather"] += kv * passes
        elif short_block(cfg.ssm, seq // M):
            out["sp_allgather"] += x * passes     # the mixer's input
        else:
            s = cfg.ssm
            C = s.d_inner(d) + 2 * s.n_groups * s.d_state
            nh = s.n_heads(d)
            out["conv_halo"] += (passes * (M - 1) * batch
                                 * (s.conv_width - 1) * C * act_bytes)
            out["ssd_state_allgather"] += (passes * (M - 1) * batch
                                           * (nh * s.head_dim * s.d_state
                                              + nh) * 4)
        if (cfg.d_ff > 0 and not has_moe) or (has_moe
                                               and cfg.moe.shared_expert):
            out["sp_allgather"] += x * passes
            out["sp_reducescatter"] += x * (2 if train else 1)
        if has_moe:
            # the (E, C, d) buffer out and back, C over the rank's tokens
            C = capacity_of(batch * seq // M, cfg.moe)
            buf = cfg.moe.n_experts * C * d * act_bytes
            out["moe_alltoall"] += 2 * passes * buf * f
    vocab_split = cfg.vocab % M == 0
    if vocab_split and cfg.family != "audio":
        out["sp_reducescatter"] += (T * d * embed_bytes * f
                                    * (2 if train else 1))
    if train:
        if vocab_split:
            scored = batch * (seq if cfg.family == "audio" else seq - 1)
            out["sp_allgather"] += 2 * x
            out["tp_allreduce"] += 3 * scored * 4 * 2 * f
        else:
            out["tp_allreduce"] += 2 * 4 * 2 * f      # the loss's sums
        if any(moe):
            out["tp_allreduce"] += 4 * 2 * f          # the aux loss's
    else:
        out["sp_allgather"] += x                      # the last position's
        if vocab_split:
            # the whole logits of the last position (an encoder's
            # forward: of every position)
            rows = T if cfg.family == "audio" else batch
            out["vocab_allgather"] += rows * cfg.vocab * act_bytes * f
    return out


def _moe_mask(cfg) -> list:
    return (cfg.moe_layer_mask() if cfg.moe is not None
            else [False] * cfg.n_layers)


def _decode_bytes(out: dict, cfg, batch: int, cache_len: int, M: int,
                  act_bytes: int, embed_bytes: int) -> Dict[str, float]:
    """:func:`sp_bytes` of one decode step: the lookup's partial rows and
    each MLP's, expert block's and SSD head block's partial sums
    all-reduced (the SSD step's gated-norm sums too, f32), each
    attention layer's softmax partials gathered where the cache is split
    (``(max, sum, P·V)``: ``head_dim + 2`` f32 a head and row), each SSD
    layer's post-conv row gathered where its channels are, and the last
    logits' columns."""
    f = (M - 1) / M
    B, d = batch, cfg.d_model
    ar = 2 * f * B * d * act_bytes      # an all-reduce of (B, d)
    if cfg.vocab % M == 0:
        out["tp_allreduce"] += 2 * f * B * d * embed_bytes
        out["vocab_allgather"] += f * B * cfg.vocab * act_bytes
    slots = (cache_len if cfg.sliding_window is None
             else min(cache_len, cfg.sliding_window))
    for kind_l, has_moe in zip(cfg.layer_kinds(), _moe_mask(cfg)):
        if kind_l == "attn":
            if slots % M == 0:
                out["softmax_combine"] += ((M - 1) * B * cfg.n_heads
                                           * (cfg.head_dim + 2) * 4)
        else:
            s = cfg.ssm
            if (s.d_inner(d) + 2 * s.n_groups * s.d_state) % M == 0:
                out["conv_allgather"] += (f * B * act_bytes
                                          * (s.d_inner(d)
                                             + 2 * s.n_groups * s.d_state))
            if s.n_heads(d) % M == 0:
                out["tp_allreduce"] += 2 * f * B * 4 + ar
        if cfg.d_ff > 0 and not has_moe:
            out["tp_allreduce"] += ar
        if has_moe:
            out["tp_allreduce"] += ar * (2 if cfg.moe.shared_expert else 1)
    return out

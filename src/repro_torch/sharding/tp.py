"""Tensor parallelism over the grid's ``model`` axis (``fsdp_tp``).

Storage follows the reference's rules exactly (:mod:`repro_torch.
sharding.fsdp`): a rank holds its ``(data, model)`` block of each leaf.
Compute is Megatron-style, the layer boundaries replicated over
``model``: every rank of a model group holds the same rows of the batch
and the same residual stream, and

* a column-parallel projection (``wq``, ``wk``, ``wv``, ``mlp/up``,
  ``mlp/gate``, ``ssm/in_*``, the experts' ``up``/``gate``, the vocab
  head) takes its input through :meth:`TP.enter`, the identity forward
  and an all-reduce of the gradient backward;
* a row-parallel projection (``wo``, ``mlp/down``, ``ssm/out``, the
  experts' ``down``) gives its partial sums to :meth:`TP.exit`, an
  all-reduce forward and the identity backward.

So a rank runs attention on its ``n_heads / M`` query heads and their
kv heads (K1-K3 unchanged on local heads), the SSD scan on its ``nh /
M`` heads (K4 unchanged), its ``E / M`` experts, its ``d_ff / M`` MLP
columns and its ``V / M`` rows of the vocabulary.  The reference's
boundaries differ: it shards d_model over ``model`` between layers
(``"embed": model`` in ``logical_axes``), so XLA all-gathers before
each projection and reduce-scatters after it; that moves the same bytes
a rank as one all-reduce, which the port issues instead.  Both count as
the analytic model's ``tp_allreduce``.

Where a rank's model block is not the block it computes, it gathers the
leaf over ``model`` (:meth:`TP.take`: an all-gather forward and a
reduce-scatter of the gradient backward) and uses its own slice:
``ssm/conv_w`` and ``conv_b``, split over the concatenated ``[x, B, C]``
channels; ``ssm/in_B``/``in_C`` when the groups do not split over the
ranks (``n_groups`` 1); ``wk``/``wv`` when the kv heads do not.  A leaf
the rules replicate over ``model`` but a rank uses only in part
(``dt_bias``, ``A_log``, ``D``; ``wk`` when its width does not divide)
takes the identity forward and an all-reduce of its gradient.  These
leaves are small.  Both count as ``tp_weights``.

The vocabulary: a sharded embedding masks the ids outside the rank's
rows and all-reduces the lookups; a sharded head (tied embeddings take
the embedding's shard) gives each rank its logits' columns, and the
cross entropy all-reduces the max, the sum of exponentials and the gold
logit over ``model`` in f32 (:meth:`Vocab.xent_chunk`); serving gathers
the whole logits on every rank (``vocab_allgather``).  Where the rule drops
``tp`` (a vocabulary the extent does not divide, e.g. granite's 49 155)
the embedding and head are replicated and used whole.

Query heads the axis does not divide (llama4-maverick's 40 at 16) are
computed whole on every rank, as the reference does: its ``attn/wq/w``
still splits over ``model``, but the ``heads`` constraint drops the axis
where it does not divide the heads, so XLA computes that attention
replicated.  Such a layer's ``wq``, ``wk``, ``wv`` and ``wo`` blocks are
gathered over ``model`` (``tp_weights``; the backward keeps the rank's
own block of the whole gradient, which every rank computes alike), the
attention and its o-projection run whole, and the mixer takes no
``tp_allreduce``.

The decode state is not what a rank computes but the rules' block
(``decode_state_shardings``, as under ``fsdp_sp``): every kv head over
the rank's ``L/M`` cache slots, its ``nh/M`` SSM heads, its ``C/M``
channels of the conv state's ``[x, B, C]`` (a dim ``M`` does not divide
whole on every rank).  A prefill reshards each layer's state to it
(:meth:`TP.reshard_kv`, an all-to-all of the slot blocks;
:meth:`TP.reshard_conv`; ``state_reshard``); a decode step gathers the
token's q, k and v from the ranks' heads (:meth:`TP.gather_qkv`,
``qkv_allgather``) and scores every head against the rank's slots, the
softmax combined over the ranks (:meth:`ModelAxis.combine_softmax`,
``softmax_combine``), and the SSD step gathers the token's ``[x, B, C]``
row (:meth:`TP.gather_xbc`, ``xbc_allgather``), convolves the rank's
channels and gathers the post-conv row (``conv_allgather``).
:class:`ModelAxis` holds what ``fsdp_tp`` and ``fsdp_sp`` share of
this: the rank's span of a state dim, its block, the distributed
softmax, the channel gather and the world-1 state from the blocks.

:class:`Plan` says from the config which heads, kv heads, SSM heads and
groups, experts and vocabulary rows rank ``m`` of ``M`` computes
(``q_heads`` None: the attention whole), and raises for any other count
the axis does not split evenly: no compute is replicated where the rules
shard it and the reference does not replicate it.
:func:`tp_allreduce_bytes` counts a step's ``tp_allreduce`` bytes from
the shapes, :func:`tp_weights_bytes` the whole attention's gathers and
:func:`tp_state_bytes` the decode state's mechanisms.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

NEXT = ("the model axis splits heads, kv heads, SSM heads and groups, "
        "experts, MLP columns and the vocabulary evenly or raises")

Range = Tuple[int, int]


def _split(n: int, M: int, m: int) -> Range:
    per = n // M
    return m * per, (m + 1) * per


def _covering(lo: int, hi: int, rep: int) -> Range:
    """The groups of ``rep`` consecutive heads that heads [lo, hi) use."""
    return lo // rep, (hi - 1) // rep + 1


def _evenly(name: str, n: int, M: int, what: str) -> None:
    if n % M:
        raise NotImplementedError(f"{name}: {what} {n} does not split "
                                  f"over a model axis of {M}; {NEXT}")


def _grouped(name: str, groups: int, M: int, what: str) -> None:
    if groups % M and M % groups:
        raise NotImplementedError(
            f"{name}: {what} {groups} neither split over nor divide a "
            f"model axis of {M}; {NEXT}")


# the per-layer decode state's model-split dim (the reference's
# decode_state_shardings, less the stacked layer dim): the cache slots of
# K/V, the SSM heads of h, the [x, B, C] channels of conv
STATE_DIM = {"k": 1, "v": 1, "h": 1, "conv": 2}


def state_shape(name: str, shape, M: int) -> tuple:
    """One layer's decode-state leaf ``name`` of whole ``shape`` as a
    model rank holds it: its split dim divided by ``M`` where ``M``
    divides it."""
    shape = list(shape)
    d = STATE_DIM[name]
    if shape[d] % M == 0:
        shape[d] //= M
    return tuple(shape)


def _assemble(parts, ranges, dim: int, width: int) -> torch.Tensor:
    """The whole of a dim whose global units ``ranges[r]`` (half-open)
    rank ``r`` holds as ``parts[r]``, ``width`` elements a unit along
    ``dim``: each unit taken from the first rank that holds it (ranks
    that share a kv head or an SSM group hold the same values)."""
    got = []
    for j in range(ranges[-1][1]):
        r = next(i for i, (a, b) in enumerate(ranges) if a <= j < b)
        got.append(parts[r].narrow(dim, (j - ranges[r][0]) * width, width))
    return torch.cat(got, dim)


def heads_whole(cfg, M: int) -> bool:
    """Whether a model axis of ``M`` leaves the attention whole on every
    rank: it does not divide the query heads (the reference's
    ``heads`` constraint drops the axis there)."""
    return cfg.has_attention and cfg.n_heads % M != 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """What rank ``m`` of a model axis of ``M`` computes: half-open
    global index ranges.  ``q_heads`` and ``kv_heads`` are None where
    ``M`` does not divide the query heads (the attention computed whole
    on every rank), ``vocab`` where the rules replicate the embedding
    and head (a vocabulary ``M`` does not divide)."""

    M: int
    m: int
    q_heads: Optional[Range] = None
    kv_heads: Optional[Range] = None
    ssm_heads: Optional[Range] = None
    ssm_groups: Optional[Range] = None
    experts: Optional[Range] = None
    vocab: Optional[Range] = None

    @classmethod
    def of(cls, cfg, M: int, m: int) -> "Plan":
        kw: Dict[str, Range] = {}
        if cfg.has_attention and not heads_whole(cfg, M):
            _grouped(cfg.name, cfg.n_kv_heads, M, "n_kv_heads")
            kw["q_heads"] = _split(cfg.n_heads, M, m)
            kw["kv_heads"] = _covering(*kw["q_heads"],
                                       cfg.n_heads // cfg.n_kv_heads)
        if cfg.ssm is not None and "ssm" in cfg.layer_kinds():
            nh = cfg.ssm.n_heads(cfg.d_model)
            _evenly(cfg.name, nh, M, "SSM heads")
            _grouped(cfg.name, cfg.ssm.n_groups, M, "n_groups")
            kw["ssm_heads"] = _split(nh, M, m)
            kw["ssm_groups"] = _covering(*kw["ssm_heads"],
                                         nh // cfg.ssm.n_groups)
        if cfg.d_ff:
            _evenly(cfg.name, cfg.d_ff, M, "d_ff")
        if cfg.moe is not None:
            _evenly(cfg.name, cfg.moe.n_experts, M, "n_experts")
            kw["experts"] = _split(cfg.moe.n_experts, M, m)
            if cfg.moe.shared_expert:
                _evenly(cfg.name, cfg.d_ff or cfg.moe.expert_d_ff, M,
                        "the shared expert's d_ff")
        if cfg.vocab % M == 0:
            kw["vocab"] = _split(cfg.vocab, M, m)
        return cls(M, m, **kw)


# --------------------------------------------------------------------------
# the operators
# --------------------------------------------------------------------------
class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward (Megatron's
    f): a replicated tensor entering a tensor-parallel region."""

    @staticmethod
    def forward(ctx, x, tp, mechanism):
        ctx.tp, ctx.mechanism = tp, mechanism
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.allreduce(grad, ctx.mechanism), None, None


class _Exit(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g): partial sums
    leaving a tensor-parallel region, replicated after it (``axis``: a
    :class:`TP` or a :class:`Vocab`)."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.allreduce(x, "tp_allreduce")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PSum(torch.autograd.Function):
    """All-reduce forward and backward: partial sums whose total is used
    inside the tensor-parallel region again (the gated norm's mean of
    squares)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.allreduce(x, "tp_allreduce")

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.allreduce(grad, "tp_allreduce"), None


class _GatherWeight(torch.autograd.Function):
    """A weight's model blocks all-gathered along ``dim`` forward, the
    gradient reduce-scattered backward: each rank uses its own part of
    the whole leaf, so the gradients are partial sums."""

    @staticmethod
    def forward(ctx, block, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.dist.all_gather(block, dim, "tp_weights", tp.group)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.tp.dist.reduce_scatter(grad, ctx.dim, "tp_weights",
                                           ctx.tp.group), None, None)


class _GatherWhole(torch.autograd.Function):
    """A weight's model blocks all-gathered along ``dim`` forward; the
    rank's own block of the gradient backward.  Every rank computes with
    the whole leaf on the same replicated input, so each holds the whole
    gradient already: nothing is summed over the axis."""

    @staticmethod
    def forward(ctx, block, dim, tp):
        ctx.dim, ctx.m, ctx.n = dim, tp.m, block.shape[dim]
        return tp.dist.all_gather(block, dim, "tp_weights", tp.group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.m * ctx.n, ctx.n), None, None


class _GatherVocab(torch.autograd.Function):
    """The ranks' logit columns gathered along the last dim forward (the
    whole logits, replicated), the rank's own columns of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, vocab):
        ctx.m, ctx.n = vocab.m, x.shape[-1]
        return vocab.dist.all_gather(x, x.dim() - 1, "vocab_allgather",
                                     vocab.group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.m * ctx.n, ctx.n), None


class Vocab:
    """The vocabulary on a model axis, shared by :class:`TP` and the
    sequence-parallel :class:`repro_torch.sharding.sp.SP`: rank ``m`` of
    ``M`` holds the rows ``rows`` of the embedding and the head (None
    where the rules replicate them, :attr:`sharded` False), and these
    are its collectives over the model ``group``."""

    def __init__(self, dist, group, M: int, m: int, rows: Optional[Range]):
        self.dist, self.group, self.M, self.m = dist, group, M, m
        self.rows = rows
        self.sharded = rows is not None

    def allreduce(self, t: torch.Tensor, mechanism: str) -> torch.Tensor:
        return self.dist.all_reduce(t, mechanism, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums all-reduced forward, the identity backward."""
        return _Exit.apply(x, self)

    def lookup(self, w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The rank's part of the lookup of ``tokens`` in a sharded
        embedding whose rows ``w`` it holds: ids outside them give
        zeros."""
        lo, hi = self.rows
        ids = tokens.long() - lo
        mine = (ids >= 0) & (ids < hi - lo)
        x = w[ids.clamp(0, hi - lo - 1)]
        return torch.where(mine[..., None], x, 0)

    def gather(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole (..., V) logits from each rank's columns."""
        return _GatherVocab.apply(logits, self)

    def xent_chunk(self, logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor):
        """The vocab-parallel cross entropy of one chunk: ``logits``
        (B, c, V/M) f32 are the rank's columns; the max, the sum of
        exponentials and the gold logit are all-reduced over ``model``
        in f32.  Returns ``(sum of nll * mask, sum of mask)``, whole on
        every rank."""
        lo, hi = self.rows
        with torch.no_grad():
            mx = self.dist.all_reduce(logits.max(dim=-1).values,
                                      "tp_allreduce", self.group, op="max")
        s = torch.exp(logits - mx[..., None]).sum(dim=-1)
        lse = torch.log(self.exit(s)) + mx
        ids = labels.long() - lo
        mine = (ids >= 0) & (ids < hi - lo)
        g = logits.gather(-1, ids.clamp(0, hi - lo - 1)[..., None])[..., 0]
        gold = self.exit(torch.where(mine, g, 0.0))
        nll = (lse - gold) * mask
        return nll.sum(), mask.sum()


class ModelAxis:
    """A rank's place on ``grid``'s model axis: its model group, its
    coordinate ``m`` of ``M``, the Megatron operators over the group
    (what :class:`TP` computes with, and :class:`repro_torch.sharding.
    sp.SP` in a decode step, whose one token is replicated over the
    axis), and the decode state on the rules' blocks that both layouts
    hold.  A subclass sets :attr:`plan` and :attr:`vocab`."""

    plan: Plan
    vocab: Vocab

    def __init__(self, grid):
        self.grid = grid
        self.dist = grid.dist
        self.group = grid.group("model")
        self.M = grid.extent("model")
        self.m = grid.coord("model")

    def allreduce(self, t: torch.Tensor, mechanism: str) -> torch.Tensor:
        return self.dist.all_reduce(t, mechanism, self.group)

    def enter(self, x: torch.Tensor, mechanism: str = "tp_allreduce"
              ) -> torch.Tensor:
        return _Enter.apply(x, self, mechanism)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(x, self)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _PSum.apply(x, self)

    def embed(self, w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The ranks' lookups in a sharded embedding summed (exact: one
        rank's row and zeros)."""
        return self.exit(self.vocab.lookup(w, tokens))


    # ----------------------------------------------------- decode state
    def span(self, n: int) -> Range:
        """``[lo, hi)`` of the rank's block of a decode-state dim of
        ``n``: its ``M``-th, or the whole where ``M`` does not divide
        ``n``."""
        return _split(n, self.M, self.m) if n % self.M == 0 else (0, n)

    def state_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's block of one layer's whole decode-state leaf, as
        ``rules.decode_state_shardings`` splits it over ``model`` (kept
        whole where ``M`` does not divide the dim)."""
        d = STATE_DIM[name]
        lo, hi = self.span(t.shape[d])
        if hi - lo == t.shape[d]:
            return t
        return t.narrow(d, lo, hi - lo).clone()

    @torch.no_grad()
    def combine_softmax(self, mx: torch.Tensor, denom: torch.Tensor,
                        pv: torch.Tensor) -> torch.Tensor:
        """The softmax-weighted values over the ranks' slots from each
        rank's row max ``mx`` (..., 1), sum of ``exp(s - mx)`` ``denom``
        (..., 1) and P·V ``pv`` (..., hd), all f32: one all-gather
        (``softmax_combine``), then each rank's partials rescaled to the
        global max and summed in rank order.  A rank whose slots are all
        masked (its max the mask's -1e30) weighs zero."""
        got = self.dist.all_gather(torch.cat([mx, denom, pv], -1)[None], 0,
                                   "softmax_combine", self.group)
        mxs, denoms, pvs = got[..., :1], got[..., 1:2], got[..., 2:]
        top = mxs.amax(dim=0)
        w = torch.where(mxs > -1e29, torch.exp(mxs - top), 0.0)
        return (w * pvs).sum(dim=0) / (w * denoms).sum(dim=0)

    @torch.no_grad()
    def gather_channels(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' channel blocks of (B, C/M) concatenated
        (``conv_allgather``)."""
        return self.dist.all_gather(x, x.dim() - 1, "conv_allgather",
                                    self.group).contiguous()

    @torch.no_grad()
    def full_decode_state(self, state: dict, cfg, cache_len: int) -> dict:
        """The world-1 decode state (stacked over layers) from the ranks'
        blocks (``state_gather``), a copy (a leaf the axis leaves whole
        too); every rank of the model group must call it."""
        whole = {"k": cache_len, "v": cache_len}
        if cfg.sliding_window is not None:
            whole = {k: min(cache_len, cfg.sliding_window) for k in whole}
        if cfg.ssm is not None:
            s, d = cfg.ssm, cfg.d_model
            whole.update(h=s.n_heads(d),
                         conv=s.d_inner(d) + 2 * s.n_groups * s.d_state)
        out = {}
        for name, t in state.items():
            dim = STATE_DIM[name] + 1
            out[name] = (t.clone() if whole[name] % self.M
                         else self.dist.all_gather(
                             t, dim, "state_gather", self.group).contiguous())
        return out


class TP(ModelAxis):
    """A rank's tensor-parallel context on ``grid``'s model axis for the
    arch ``cfg``: its model group, its coordinate ``m`` of ``M`` and its
    :class:`Plan`, and its :class:`Vocab`."""

    def __init__(self, grid, cfg):
        super().__init__(grid)
        self.plan = Plan.of(cfg, self.M, self.m)
        # every rank's plan: which kv heads and SSM groups each computes
        self.plans = [Plan.of(cfg, self.M, r) for r in range(self.M)]
        self.vocab = Vocab(self.dist, self.group, self.M, self.m,
                           self.plan.vocab)

    # ------------------------------------------------------- collectives

    def take(self, w: torch.Tensor, dim: int, full: int, lo: int,
             hi: int) -> torch.Tensor:
        """Global ``[lo, hi)`` along ``dim`` of a leaf whose whole size
        there is ``full``, from the rank's block ``w`` (the model block
        of a leaf split over ``model``, or the whole of one the rules
        replicate over it), differentiably: the block itself where it is
        that range; else the leaf gathered over ``model`` (split) or
        entered (replicated), then narrowed."""
        size = w.shape[dim]
        if size == full:
            w = self.enter(w, "tp_weights")
        elif size * self.M == full:
            if (lo, hi) == (self.m * size, (self.m + 1) * size):
                return w
            w = _GatherWeight.apply(w, dim, self)
        else:
            raise ValueError(f"a block of {size} of {full} on a model axis "
                             f"of {self.M}")
        return w.narrow(dim, lo, hi - lo)

    # ------------------------------------------------------------ layers
    @property
    def heads_whole(self) -> bool:
        """The attention runs whole on every rank (:func:`heads_whole`)."""
        return self.plan.q_heads is None

    def attn_enter(self, x: torch.Tensor) -> torch.Tensor:
        """The attention's input: entered into the tensor-parallel
        region, or as it is where the attention runs whole."""
        return x if self.heads_whole else self.enter(x)

    def attn_exit(self, out: torch.Tensor) -> torch.Tensor:
        """The o-projection's output: partial sums all-reduced, or as it
        is where the attention runs whole."""
        return out if self.heads_whole else self.exit(out)

    def _whole(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        if w.shape[dim] == full:
            return w
        return _GatherWhole.apply(w, dim, self)

    def attn(self, params: dict, spec):
        """The rank's query heads' and their kv heads' weights, and the
        spec of those local heads; where the attention runs whole, the
        whole weights (their model blocks gathered) and ``spec``."""
        hd = spec.head_dim
        if self.heads_whole:
            H, Kh = spec.n_heads * hd, spec.n_kv_heads * hd
            return {"wq": {"w": self._whole(params["wq"]["w"], 1, H)},
                    "wk": {"w": self._whole(params["wk"]["w"], 1, Kh)},
                    "wv": {"w": self._whole(params["wv"]["w"], 1, Kh)},
                    "wo": {"w": self._whole(params["wo"]["w"], 0, H)}}, spec
        (q0, q1), (k0, k1) = self.plan.q_heads, self.plan.kv_heads
        H, Kh = spec.n_heads * hd, spec.n_kv_heads * hd
        local = {
            "wq": {"w": self.take(params["wq"]["w"], 1, H, q0 * hd,
                                  q1 * hd)},
            "wk": {"w": self.take(params["wk"]["w"], 1, Kh, k0 * hd,
                                  k1 * hd)},
            "wv": {"w": self.take(params["wv"]["w"], 1, Kh, k0 * hd,
                                  k1 * hd)},
            "wo": {"w": self.take(params["wo"]["w"], 0, H, q0 * hd,
                                  q1 * hd)}}
        return local, dataclasses.replace(spec, n_heads=q1 - q0,
                                          n_kv_heads=k1 - k0)

    def ssm(self, params: dict, cfg, d_model: int, conv: bool = True):
        """The SSD mixer's weights for the rank's heads and groups: the
        head-split leaves as they are, ``in_B``/``in_C`` at its groups,
        ``conv_w``/``conv_b`` at its ``[x, B, C]`` channels (with
        ``conv`` False: the rank's model blocks as they are, the rules'
        channel block a decode step convolves) and the per-head vectors
        at its heads.  Returns ``(params, heads, groups)``."""
        (h0, h1), (g0, g1) = self.plan.ssm_heads, self.plan.ssm_groups
        hp, N = cfg.head_dim, cfg.d_state
        nh, di = cfg.n_heads(d_model), cfg.d_inner(d_model)
        gN = cfg.n_groups * N
        local = dict(params)
        for k in ("in_B", "in_C"):
            local[k] = {"w": self.take(params[k]["w"], 1, gN, g0 * N,
                                       g1 * N)}
        for k in ("dt_bias", "A_log", "D"):
            local[k] = self.take(params[k], 0, nh, h0, h1)
        C = di + 2 * gN
        for k, dim in (("conv_w", 1), ("conv_b", 0)) if conv else ():
            whole = self.take(params[k], dim, C, 0, C)
            local[k] = torch.cat([
                whole.narrow(dim, h0 * hp, (h1 - h0) * hp),
                whole.narrow(dim, di + g0 * N, (g1 - g0) * N),
                whole.narrow(dim, di + gN + g0 * N, (g1 - g0) * N)], dim)
        return local, h1 - h0, g1 - g0

    # ------------------------------------------------------------ decode
    def _kv_ranges(self) -> list:
        return [p.kv_heads for p in self.plans]

    @torch.no_grad()
    def gather_qkv(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """A decode token's whole q (B,1,H,hd), k and v (B,1,Kh,hd) from
        the rank's heads' and kv heads' (one all-gather of the three,
        ``qkv_allgather``); a kv head that ranks share comes from the
        first that holds it."""
        B, _, Hl, hd = q.shape
        Kl = k.shape[2]
        parts = self.dist.all_gather(torch.cat([q, k, v], 2)[None], 0,
                                     "qkv_allgather", self.group)
        q = parts[..., :Hl, :].permute(1, 2, 0, 3, 4).reshape(
            B, 1, self.M * Hl, hd)
        k, v = (_assemble([p[..., Hl + i * Kl:Hl + (i + 1) * Kl, :]
                           for p in parts], self._kv_ranges(), 2, 1)
                for i in (0, 1))
        return q, k, v

    @torch.no_grad()
    def gather_xbc(self, row: torch.Tensor, cfg) -> torch.Tensor:
        """A decode token's whole ``[x, B, C]`` row (B, C) from the rank's
        x columns and its groups' B and C (``row``: (B, di/M + 2 g N),
        ``g`` its groups): one all-gather (``xbc_allgather``).  ``cfg``:
        the SSM config."""
        return self._whole_xbc(self.dist.all_gather(
            row[None], 0, "xbc_allgather", self.group), cfg)

    def _whole_xbc(self, parts: torch.Tensor, cfg) -> torch.Tensor:
        """The whole ``[x, B, C]`` channels (last dim) from every rank's
        x columns and its groups' B and C (``parts``: dim 0 the ranks)."""
        (h0, h1), (g0, g1) = self.plan.ssm_heads, self.plan.ssm_groups
        N = cfg.d_state
        x_w, g_w = (h1 - h0) * cfg.head_dim, (g1 - g0) * N
        groups = [p.ssm_groups for p in self.plans]
        xs = torch.cat([p[..., :x_w] for p in parts], -1)
        B = _assemble([p[..., x_w:x_w + g_w] for p in parts], groups, -1, N)
        C = _assemble([p[..., x_w + g_w:] for p in parts], groups, -1, N)
        return torch.cat([xs, B, C], -1)

    @torch.no_grad()
    def reshard_kv(self, k: torch.Tensor, v: torch.Tensor):
        """A prefill's cache ``k``, ``v`` (B, L, Kh/M, hd) of the rank's kv
        heads over every slot, as the rules' block: every kv head over the
        rank's ``L/M`` slots (``span``).  One all-to-all of the slot blocks
        (``state_reshard``); where ``M`` does not divide ``L`` the cache
        is whole on every rank, one all-gather; where the attention runs
        whole, a narrow with no collective."""
        if self.heads_whole:
            return self.state_block("k", k), self.state_block("v", v)
        B, L, Kl, hd = k.shape
        kv = torch.stack([k, v])                      # (2, B, L, Kl, hd)
        if L % self.M:
            parts = self.dist.all_gather(kv[None], 0, "state_reshard",
                                         self.group)
        else:
            blocks = kv.reshape(2, B, self.M, L // self.M, Kl, hd)
            parts = self.dist.all_to_all(blocks.movedim(2, 0),
                                         "state_reshard", self.group)
        whole = _assemble(list(parts), self._kv_ranges(), 3, 1)
        return whole[0], whole[1]

    @torch.no_grad()
    def reshard_conv(self, conv: torch.Tensor, cfg) -> torch.Tensor:
        """A prefill's conv state (B, W-1, di/M + 2 g N) of the rank's x
        columns and groups' B and C, as the rules' channel block
        (``state_block``) of the whole ``[x, B, C]``: one all-gather
        (``state_reshard``), then the rank's block.  ``cfg``: the SSM
        config."""
        parts = self.dist.all_gather(conv[None], 0, "state_reshard",
                                     self.group)
        return self.state_block("conv", self._whole_xbc(parts, cfg))

# --------------------------------------------------------------------------
# the shape count
# --------------------------------------------------------------------------
def tp_allreduce_bytes(cfg, batch: int, seq: int, kind: str, M: int,
                       act_bytes: int, embed_bytes: int = None) -> float:
    """A rank's ``tp_allreduce`` bytes in one step of ``kind`` (train,
    prefill or decode) over ``batch`` local rows of ``seq`` tokens (1 for
    decode) on a model axis of ``M``, in the ring convention (an
    all-reduce of F bytes moves ``2 (M-1)/M F`` a rank).  Activations
    are ``act_bytes`` an element, the embedding's lookups
    ``embed_bytes`` (default: the same); the norms' squares and the
    cross entropy's terms are f32.  Training runs each layer's forward
    twice (remat) and its backward once; the recompute stops after the
    last op that saves a tensor for the backward, so it skips each
    layer's last all-reduce (its output's).  An attention the axis
    leaves whole (:func:`heads_whole`) takes none.  Counts the text and
    audio families (a vlm's patches take no lookup)."""
    if M == 1:
        return 0.0
    embed_bytes = act_bytes if embed_bytes is None else embed_bytes
    T = batch * (1 if kind == "decode" else seq)
    d = cfg.d_model
    x = T * d * act_bytes
    fwd = bwd = last = 0.0
    kinds = cfg.layer_kinds()
    moe_mask = (cfg.moe_layer_mask() if cfg.moe is not None
                else [False] * cfg.n_layers)
    whole = heads_whole(cfg, M)
    for kind_l, has_moe in zip(kinds, moe_mask):
        # the layer's last all-reduce, which remat's recompute skips
        end = 0.0
        if kind_l != "attn" or not whole:
            fwd += x                  # the mixer's output
            bwd += x                  # its input's gradient
            end = x
        if kind_l == "ssm":
            fwd += T * 4              # the gated norm's sum of squares
            bwd += T * 4
        if has_moe:
            fwd += x                  # the experts' combine
            bwd += x + T * cfg.moe.top_k * 4     # the tokens, the gates
            end = x
            if cfg.moe.shared_expert:
                fwd += x
                bwd += x
        elif cfg.d_ff > 0:
            fwd += x
            bwd += x
            end = x
        last += end
    total = fwd
    if kind == "train":
        total = 2 * fwd - last + bwd
    if cfg.vocab % M == 0:
        if cfg.family != "audio":
            total += T * d * embed_bytes          # the sharded lookup
        if kind == "train":
            scored = batch * (seq if cfg.family == "audio" else seq - 1)
            total += x + 3 * scored * 4   # the head's input; max, sum, gold
    return total * 2 * (M - 1) / M


def tp_weights_bytes(cfg, kind: str, M: int, esize: int) -> float:
    """A rank's ``tp_weights`` bytes in one step of ``kind`` from the
    attention weights gathered over ``model`` where the attention runs
    whole (:func:`heads_whole`; 0 elsewhere): each layer's ``wq``,
    ``wk``, ``wv`` and ``wo`` whose width the axis splits, gathered in
    the forward and again in a train step's recompute (the backward
    sends nothing), ``(M-1)/M`` of the whole leaf in the ring
    convention.  ``esize``: the weights' bytes an element."""
    if M == 1 or not heads_whole(cfg, M):
        return 0.0
    d, hd = cfg.d_model, cfg.head_dim
    widths = (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd,
              cfg.n_heads * hd)
    per_layer = sum(d * w * esize for w in widths if w % M == 0)
    n_attn = cfg.layer_kinds().count("attn")
    passes = 2 if kind == "train" else 1
    return n_attn * passes * per_layer * (M - 1) / M


# the mechanisms of fsdp_tp's decode state on the rules' blocks
STATE_MECHANISMS = ("state_reshard", "qkv_allgather", "softmax_combine",
                    "xbc_allgather", "conv_allgather")


def tp_state_bytes(cfg, batch: int, cache_len: int, kind: str, M: int,
                   act_bytes: int) -> Dict[str, float]:
    """A rank's bytes by :data:`STATE_MECHANISMS` in one ``fsdp_tp``
    prefill (``kind`` ``"prefill"``) or decode step (``"decode"``) of
    ``batch`` local rows on a cache of ``cache_len`` slots, the decode
    state on the rules' blocks, in the ring convention (a gather of F
    whole bytes or an all-to-all of F bytes moves ``(M-1)/M F`` a rank).
    The prefill's ``state_reshard``: each attention layer's K/V of the
    rank's kv heads sent to the slots' owners (an all-to-all; an
    all-gather where ``M`` does not divide the cache, nothing where the
    attention runs whole) and each SSD layer's conv rows of the rank's
    ``[x, B, C]`` columns all-gathered.  A decode step: each attention
    layer's token q, k and v all-gathered (``qkv_allgather``, not where
    the attention runs whole) and its softmax partials where the cache
    is split (``softmax_combine``: ``head_dim + 2`` f32 a head and row),
    each SSD layer's ``[x, B, C]`` columns (``xbc_allgather``) and its
    post-conv row where the channels are split (``conv_allgather``).
    Activations, caches and conv rows are ``act_bytes`` an element."""
    out = dict.fromkeys(STATE_MECHANISMS, 0.0)
    if M == 1:
        return out
    B, hd = batch, cfg.head_dim
    whole = heads_whole(cfg, M)
    L = (cache_len if cfg.sliding_window is None
         else min(cache_len, cfg.sliding_window))
    for kind_l in cfg.layer_kinds():
        if kind_l == "attn":
            Kl = cfg.n_kv_heads // M if cfg.n_kv_heads % M == 0 else 1
            if kind == "prefill" and not whole:
                kv = 2 * B * L * Kl * hd * act_bytes
                out["state_reshard"] += (kv * (M - 1) / M if L % M == 0
                                         else kv * (M - 1))
            elif kind == "decode":
                if not whole:
                    out["qkv_allgather"] += ((M - 1) * B * hd * act_bytes
                                             * (cfg.n_heads // M + 2 * Kl))
                if L % M == 0:
                    out["softmax_combine"] += ((M - 1) * B * cfg.n_heads
                                               * (hd + 2) * 4)
        else:
            s = cfg.ssm
            nh, N = s.n_heads(cfg.d_model), s.d_state
            groups = (s.n_groups // M if s.n_groups % M == 0 else 1)
            cols = (nh // M) * s.head_dim + 2 * groups * N
            C = s.d_inner(cfg.d_model) + 2 * s.n_groups * N
            if kind == "prefill":
                out["state_reshard"] += ((M - 1) * B * (s.conv_width - 1)
                                         * cols * act_bytes)
            elif kind == "decode":
                out["xbc_allgather"] += (M - 1) * B * cols * act_bytes
                if C % M == 0:
                    out["conv_allgather"] += B * C * act_bytes * (M - 1) / M
    return out

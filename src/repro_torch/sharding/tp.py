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
the whole logits on every rank (``vocab_allgather``), and
:meth:`TP.full_decode_state` the whole decode state
(``tp_state_gather``).  Where the rule drops
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

:class:`Plan` says from the config which heads, kv heads, SSM heads and
groups, experts and vocabulary rows rank ``m`` of ``M`` computes
(``q_heads`` None: the attention whole), and raises for any other count
the axis does not split evenly: no compute is replicated where the rules
shard it and the reference does not replicate it.
:func:`tp_allreduce_bytes` counts a step's ``tp_allreduce`` bytes from
the shapes, :func:`tp_weights_bytes` the whole attention's gathers.
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
    coordinate ``m`` of ``M``, and the Megatron operators over the group
    (what :class:`TP` computes with, and :class:`repro_torch.sharding.
    sp.SP` in a decode step, whose one token is replicated over the
    axis).  A subclass sets :attr:`plan` and :attr:`vocab`."""

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


class TP(ModelAxis):
    """A rank's tensor-parallel context on ``grid``'s model axis for the
    arch ``cfg``: its model group, its coordinate ``m`` of ``M`` and its
    :class:`Plan`, and its :class:`Vocab`."""

    def __init__(self, grid, cfg):
        super().__init__(grid)
        self.plan = Plan.of(cfg, self.M, self.m)
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

    def ssm(self, params: dict, cfg, d_model: int):
        """The SSD mixer's weights for the rank's heads and groups: the
        head-split leaves as they are, ``in_B``/``in_C`` at its groups,
        ``conv_w``/``conv_b`` at its ``[x, B, C]`` channels and the
        per-head vectors at its heads.  Returns ``(params, heads,
        groups)``."""
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
        for k, dim in (("conv_w", 1), ("conv_b", 0)):
            whole = self.take(params[k], dim, C, 0, C)
            local[k] = torch.cat([
                whole.narrow(dim, h0 * hp, (h1 - h0) * hp),
                whole.narrow(dim, di + g0 * N, (g1 - g0) * N),
                whole.narrow(dim, di + gN + g0 * N, (g1 - g0) * N)], dim)
        return local, h1 - h0, g1 - g0

    # ----------------------------------------------------- decode state
    @torch.no_grad()
    def full_decode_state(self, state: dict, cfg) -> dict:
        """The world-1 decode state from the ranks' (every rank must
        call it): K/V over the kv heads, ``h`` over the SSM heads and
        ``conv`` over its ``[x, B, C]`` channels, each global head or
        group taken from the first rank that holds it."""
        plans = [Plan.of(cfg, self.M, r) for r in range(self.M)]
        out = {}

        def pieces(t, dim):
            return torch.chunk(self.dist.all_gather(
                t, dim, "tp_state_gather", self.group), self.M, dim)

        def assemble(parts, ranges, dim, width):
            got = []
            for j in range(ranges[-1][1]):
                r = next(i for i, (a, b) in enumerate(ranges) if a <= j < b)
                got.append(parts[r].narrow(dim, (j - ranges[r][0]) * width,
                                           width))
            return torch.cat(got, dim)

        for name in ("k", "v"):
            if name in state:
                out[name] = (state[name] if self.heads_whole else assemble(
                    pieces(state[name], 3), [p.kv_heads for p in plans],
                    3, 1))
        if "h" in state:
            out["h"] = torch.cat(pieces(state["h"], 2), 2)
        if "conv" in state:
            s = cfg.ssm
            hp, N = s.head_dim, s.d_state
            parts = pieces(state["conv"], 3)
            x_w = (plans[0].ssm_heads[1] - plans[0].ssm_heads[0]) * hp
            g_w = (plans[0].ssm_groups[1] - plans[0].ssm_groups[0]) * N
            xs = torch.cat([p.narrow(3, 0, x_w) for p in parts], 3)
            groups = [p.ssm_groups for p in plans]
            B = assemble([p.narrow(3, x_w, g_w) for p in parts], groups,
                         3, N)
            C = assemble([p.narrow(3, x_w + g_w, g_w) for p in parts],
                         groups, 3, N)
            out["conv"] = torch.cat([xs, B, C], 3)
        return out


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

"""Sequence parallelism over the grid's ``model`` axis (``fsdp_sp``).

Storage follows the reference's rules (:mod:`repro_torch.sharding.fsdp`):
the attention and SSM projections, ``conv_w``, ``conv_b`` and
``norm_scale`` are split over both axes (``fsdp2``) and gathered whole
where a layer runs; the MLP and the vocabulary keep ``fsdp_tp``'s
``(fsdp, tp)`` blocks.  Compute follows the reference's activations
(``logical_axes``): the **sequence** is split over ``model`` at the layer
boundaries, so rank ``m`` of ``M`` holds positions ``[m S/M, (m+1) S/M)``
of its data row's rows, and

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
  ``conv_halo``);
* the MLP is Megatron's sequence-parallel trade on its column and row
  blocks: :meth:`SP.gather_seq` before ``up``/``gate`` (an all-gather
  forward, a reduce-scatter backward: ``sp_allgather``) and
  :meth:`SP.scatter_seq` after ``down`` (a reduce-scatter of the partial
  sums forward, an all-gather backward: ``sp_reducescatter``);
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

:class:`SP` holds the vocabulary's rows and collectives as a
:class:`repro_torch.sharding.tp.Vocab`, which :class:`repro_torch.
sharding.tp.TP` holds too.

What is not run raises, naming its ROADMAP step: an MoE FFN slot (the
experts' all-to-all, step 5.2), decode (a softmax over the
sequence-sharded cache, step 5.1b), a block shorter than the SSM chunk
(the reference gathers the sequence there; step 5.1's open item) and a
prefill with ragged ``lengths``.  :func:`sp_bytes` counts a step's bytes
by mechanism from the shapes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding.tp import Vocab, _evenly, _split

STEP = "ROADMAP.md Queue 1 item 1 step"
MOE_NEXT = (f"fsdp_sp on a model axis does not run an MoE FFN slot: its "
            f"experts' all-to-all over sequence-split tokens is {STEP} 5.2")
DECODE_NEXT = (f"fsdp_sp on a model axis has no decode step: a softmax "
               f"distributed over the sequence-sharded cache is {STEP} 5.1b")
SHORT_NEXT = (f"the reference gathers the whole sequence below the chunk "
              f"and the port does not ({STEP} 5.1, its open item)")
RAGGED_NEXT = (f"fsdp_sp's prefill takes no ragged lengths (the "
               f"reference's sharded build_prefill passes none; {STEP} 5.1)")
# the per-layer decode state's sequence-split dim (the reference's
# decode_state_shardings, less the stacked layer dim): the cache slots of
# K/V, the SSM heads of h, the [x, B, C] channels of conv
STATE_DIM = {"k": 1, "v": 1, "h": 1, "conv": 2}


def check_config(cfg, seq: int, M: int) -> None:
    """Raise unless ``cfg`` runs ``fsdp_sp`` at ``seq`` tokens on a model
    axis of ``M``: no MoE FFN slot, ``M`` dividing ``seq``, and a block
    at least an SSM's chunk (and its conv's ``W - 1`` rows)."""
    if cfg.moe is not None and any(cfg.moe_layer_mask()):
        raise NotImplementedError(f"{cfg.name}: {MOE_NEXT}")
    if seq % M:
        raise ValueError(f"{cfg.name}: a sequence of {seq} does not split "
                         f"into {M} blocks")
    if cfg.ssm is not None and "ssm" in cfg.layer_kinds():
        block = seq // M
        if block < cfg.ssm.chunk or block < cfg.ssm.conv_width - 1:
            raise NotImplementedError(
                f"{cfg.name}: a sequence block of {block} is shorter than "
                f"the SSM chunk {cfg.ssm.chunk}; {SHORT_NEXT}")


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


# --------------------------------------------------------------------------
class SP:
    """A rank's sequence-parallel context on ``grid``'s model axis for
    the arch ``cfg``: its model group, its coordinate ``m`` of ``M`` and
    its :class:`repro_torch.sharding.tp.Vocab`."""

    def __init__(self, grid, cfg):
        self.grid = grid
        self.dist = grid.dist
        self.group = grid.group("model")
        self.M = grid.extent("model")
        self.m = grid.coord("model")
        if cfg.moe is not None and any(cfg.moe_layer_mask()):
            raise NotImplementedError(f"{cfg.name}: {MOE_NEXT}")
        if cfg.d_ff:
            _evenly(cfg.name, cfg.d_ff, self.M, "d_ff")
        rows = (_split(cfg.vocab, self.M, self.m) if cfg.vocab % self.M == 0
                else None)
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

    # ----------------------------------------------------- decode state
    def state_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's block of one layer's whole decode-state leaf, as
        ``rules.decode_state_shardings`` splits it over ``model`` (kept
        whole where ``M`` does not divide the dim)."""
        d = STATE_DIM[name]
        if t.shape[d] % self.M:
            return t
        return self.narrow(t, d).clone()

    @torch.no_grad()
    def full_decode_state(self, state: dict, cfg, cache_len: int) -> dict:
        """The world-1 decode state (stacked over layers) from the ranks'
        blocks; every rank of the model group must call it."""
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
            out[name] = (t if whole[name] % self.M else self.dist.all_gather(
                t, dim, "sp_state_gather", self.group).contiguous())
        return out


# --------------------------------------------------------------------------
# the shape count
# --------------------------------------------------------------------------
def sp_bytes(cfg, batch: int, seq: int, kind: str, M: int, act_bytes: int,
             embed_bytes: Optional[int] = None) -> Dict[str, float]:
    """A rank's bytes by mechanism in one ``fsdp_sp`` step of ``kind``
    (train or prefill) over ``batch`` rows of ``seq`` tokens (the whole
    sequence of its data row; a vlm's patches included) on a model axis
    of ``M``, in the ring convention (a gather or reduce-scatter of F
    whole bytes moves ``(M-1)/M F`` a rank).  Activations are
    ``act_bytes`` an element, the embedding's lookups ``embed_bytes``
    (default: the same); states, decays and the loss's terms are f32, and
    the logits in the activations' dtype.
    Training runs each layer's forward twice (remat) and its backward
    once; the recompute stops after the last op that saves a tensor, so
    it skips each MLP's ``scatter_seq``.  The FSDP gathers and reductions
    are not counted here (:mod:`repro_torch.analysis.analytic`)."""
    out = dict.fromkeys(("kv_allgather", "sp_allgather", "sp_reducescatter",
                         "conv_halo", "ssd_state_allgather",
                         "tp_allreduce", "vocab_allgather"), 0.0)
    if M == 1:
        return out
    if kind not in ("train", "prefill"):
        raise NotImplementedError(DECODE_NEXT)
    embed_bytes = act_bytes if embed_bytes is None else embed_bytes
    f = (M - 1) / M
    train = kind == "train"
    T, d = batch * seq, cfg.d_model
    x = T * d * act_bytes * f
    kinds = cfg.layer_kinds()
    has_ffn = cfg.d_ff > 0
    for kind_l in kinds:
        if kind_l == "attn":
            kv = 2 * T * cfg.n_kv_heads * cfg.head_dim * act_bytes * f
            out["kv_allgather"] += kv * (3 if train else 1)
        else:
            s = cfg.ssm
            C = s.d_inner(d) + 2 * s.n_groups * s.d_state
            nh = s.n_heads(d)
            passes = 3 if train else 1
            out["conv_halo"] += (passes * (M - 1) * batch
                                 * (s.conv_width - 1) * C * act_bytes)
            out["ssd_state_allgather"] += (passes * (M - 1) * batch
                                           * (nh * s.head_dim * s.d_state
                                              + nh) * 4)
        if has_ffn:
            out["sp_allgather"] += x * (3 if train else 1)
            out["sp_reducescatter"] += x * (2 if train else 1)
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
    else:
        out["sp_allgather"] += x                      # the last position's
        if vocab_split:
            # the whole logits of the last position (an encoder's
            # forward: of every position)
            rows = T if cfg.family == "audio" else batch
            out["vocab_allgather"] += rows * cfg.vocab * act_bytes * f
    return out

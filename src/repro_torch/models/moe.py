"""Mixture-of-Experts layer with capacity-based token-choice routing.  Port
of ``repro.models.moe``.

Top-k expert assignment with a static per-expert capacity: tokens are
scattered into a dense ``(E, capacity, d)`` buffer, the expert FFNs run as
one batched matmul against the stacked ``(E, d, ff)`` expert weights, and
the outputs are gathered back per token.  Tokens over capacity are
dropped; the aux load-balance loss keeps drops rare.  The reference also
computes this product outside any Pallas kernel, so the port has no
kernel here either.

Tokens are dispatched in G = gb x gs groups, each with its own capacity
(:func:`_dispatch_groups`, the reference's: the extents of the active
:class:`repro_torch.sharding.ShardCtx`'s ``batch`` and ``seq`` axes; one
group without a ctx).  Routing, ranking, the capacity scatter and the
gather are group-local; the expert FFN runs every group's slots in one
batched product.  On a rank of a data grid the ctx has every extent at
1, so each rank's rows are its group: what the reference's data-parallel
layout dispatches.

Under ``fsdp_tp`` on a ``model`` axis (``tp``, a
:class:`repro_torch.sharding.tp.TP`) the tokens are replicated over the
axis, so the dispatch stays rank-local: the router is replicated and
routes identically on every model rank, each rank runs its ``E / M``
experts on the slots routed to them, and the partial combines are
all-reduced (the tokens and the gates enter the experts' region through
an all-reduce of their gradients; the aux loss, computed alike on every
rank, counts once).  A decode step under ``fsdp_sp`` takes the same
path: its one token is replicated over the axis, and the reference's
grouping falls back to one group there.

Under ``fsdp_sp``'s sequence split (``sp``, a
:class:`repro_torch.sharding.sp.SP`) the rank's block of the sequence is
its dispatch group, as the reference's ``_dispatch_groups`` gives ``gs =
M``: capacity is counted over its ``B x S/M`` tokens, and the router,
the top-k, the ranks and the scatter stay local.  The ``(E, C, d)``
buffer crosses to the experts' owners in one all-to-all
(``SP.exchange_experts``), each rank runs its ``E / M`` experts on
every group's slots in one batched product, and the outputs cross back
for a local combine.  The aux loss returned is the block's; the loss
averages it over the blocks.

Every detail that decides which tokens an expert takes follows the
reference: the router in f32, top-k by k iterated argmaxes (a tie goes
to the first index), ranks by a stable sort with masked tokens under a
sentinel expert id E, the capacity counted over the padded tokens, and
the gather clamping the sentinel to E - 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import DEFAULT_INIT_SCALE, dense_init
from repro_torch.sharding.ctx import axis_extent_of


def moe_init(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             act: str, dtype, device) -> dict:
    """The router is f32 whatever ``dtype`` is, as in the reference."""
    E, f = cfg.n_experts, cfg.expert_d_ff

    def ekernel(a, b):
        w = torch.randn((E, a, b), generator=generator, dtype=torch.float32,
                        device=device) * DEFAULT_INIT_SCALE
        return w.to(dtype)

    p = {"router": dense_init(generator, d_model, E, torch.float32, device),
         "up": ekernel(d_model, f),
         "down": ekernel(f, d_model)}
    if act == "silu":
        p["gate"] = ekernel(d_model, f)
    return p


def router_probs(params, x):
    """x: (T, d) -> ((T, E) f32 probabilities, logits).  A compute cast may
    have made the router bf16; it is read in f32, as the reference's
    promotion does."""
    logits = x.float() @ params["router"]["w"].float()
    return torch.softmax(logits, dim=-1), logits


def load_balance_loss(probs, expert_mask):
    """GShard aux loss: E * sum_e f_e * p_e.

    probs: (T, E) router probabilities; expert_mask: (T, E) 0/1 counts of
    routed (pre-drop) assignments summed over k.
    """
    E = probs.shape[-1]
    f = expert_mask.mean(dim=0)           # fraction of tokens per expert
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


def _axis_extent(logical_name: str) -> int:
    return axis_extent_of(logical_name)


def _dispatch_groups(B: int, S: int):
    """(batch groups, seq groups): one group per (data shard x seq
    shard) of the active ctx, an axis that does not divide its dim
    counting 1."""
    gs = _axis_extent("seq")
    if gs <= 1 or S % gs:
        gs = 1
    gb = _axis_extent("batch")
    if gb <= 1 or B % gb:
        gb = 1
    return gb, gs


def _local_top_k(x: torch.Tensor, k: int):
    """top_k over the last dim via k iterated maxima, a tie going to the
    first index.  The reference subtracts 1e9 from each pick; the port
    writes -inf there, which no later maximum can take either (the inputs
    are probabilities), in two operations a pick where the subtraction
    takes six (decode is bound by the host's launches)."""
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        v, i = cur.max(dim=-1)
        vals.append(v)
        idxs.append(i)
        cur = cur.scatter(-1, i[..., None], float("-inf"))
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def _ranks_in_expert(e_ids: torch.Tensor, E: int) -> torch.Tensor:
    """Position of each entry within its expert's segment, via a stable
    argsort.  ids may include the sentinel E (masked tokens): sentinels
    form their own segment ranked like any other, so real experts' ranks
    never shift."""
    n = e_ids.shape[0]
    order = torch.argsort(e_ids, stable=True)
    sorted_e = e_ids[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E + 1, device=e_ids.device))
    rank_sorted = torch.arange(n, device=e_ids.device) - seg_start[sorted_e]
    ranks = torch.empty(n, dtype=torch.int64, device=e_ids.device)
    ranks[order] = rank_sorted
    return ranks


def capacity_of(n_tokens: int, cfg: MoEConfig,
                capacity_factor: float = None) -> int:
    """Slots per expert: ``max(int(T*K/E*cf), 4)`` over the T tokens of
    the group, pads included."""
    if capacity_factor is None:
        capacity_factor = cfg.capacity_factor
    return max(int(n_tokens * cfg.top_k / cfg.n_experts * capacity_factor),
               4)


def route(params, xt, cfg: MoEConfig, capacity: int, token_mask=None,
          groups: int = 1):
    """Routing of the (T, d) tokens, ``groups`` consecutive groups of T /
    groups: router probabilities (T, E), the renormalised gates (T, K),
    and per (token, k) entry its expert id ``e`` (E for a masked token),
    its group ``g``, its rank in that expert within its group, whether it
    is kept and the buffer slot it reads."""
    E, K = cfg.n_experts, cfg.top_k
    T = xt.shape[0]
    probs, _ = router_probs(params, xt)                    # (T, E)
    gate_vals, expert_idx = _local_top_k(probs, K)         # (T, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1,
                                          keepdim=True).clamp_min(1e-9)
    if token_mask is not None:
        expert_idx = torch.where(token_mask.reshape(T, 1), expert_idx, E)
    e = expert_idx.reshape(T * K)
    # each entry's group, 0 for one group (no group arithmetic then)
    g = 0 if groups == 1 else torch.arange(
        groups, device=e.device).repeat_interleave(T * K // groups)
    # one segment per (group, expert id), the sentinel's included
    rank = _ranks_in_expert(_in_group(g, e, E + 1), groups * (E + 1) - 1)
    keep = rank < capacity
    return {"probs": probs, "gates": gate_vals, "e": e, "g": g, "rank": rank,
            "keep": keep, "slot": torch.where(keep, rank, capacity - 1)}


def _in_group(g, ids, width: int):
    """``ids`` moved to their group's block of ``width`` (``g`` is 0 for
    one group: the ids as they are)."""
    return ids if isinstance(g, int) else g * width + ids


def dispatch(xt, r: dict, E: int, K: int, capacity: int, groups: int = 1,
             experts=None):
    """The (groups * E, capacity, d) expert buffer, group-major.  The
    reference scatter-adds x * keep at (e, slot) and drops the sentinel
    rows; a dropped token adds zeros, so writing only the kept rows of
    real experts gives the same buffer bit for bit.  The other rows go
    to one spare row past the end, which is cut off: no mask of
    data-dependent length, so no wait for the device.  ``experts``
    ``(lo, hi)`` keeps the rows of those experts only (a model rank's):
    a (groups * (hi - lo), capacity, d) buffer."""
    d = xt.shape[1]
    lo, hi = (0, E) if experts is None else experts
    n = hi - lo
    rows = groups * n * capacity
    e = r["e"]
    if experts is None:
        put = r["keep"] & (e < E)
    else:
        put = r["keep"] & (e >= lo) & (e < hi)
        e = e - lo
    row = torch.where(put, _in_group(r["g"], e, n) * capacity + r["rank"],
                      rows)
    buf = xt.new_zeros((rows + 1, d))
    buf[row] = xt.repeat_interleave(K, dim=0)
    return buf[:-1].view(groups * n, capacity, d)


def expert_ffn(params, buf, act: str):
    """Each expert's FFN over its slots: batched matmuls against the
    stacked (E, d, ff) weights."""
    h = torch.bmm(buf, params["up"])
    if act == "silu":
        h = F.silu(torch.bmm(buf, params["gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return torch.bmm(h, params["down"])


def combine(out_buf, r: dict, masked: bool, gates=None, experts=None):
    """(T, d): each token's kept expert outputs weighted by its gates
    (``gates``, default the route's), from the (groups * E, capacity, d)
    buffer.  The gather clamps the sentinel E to E - 1, as a JAX gather
    does; with a token mask its gradient drops the sentinel rows, as the
    JAX gather's transpose does.  ``experts`` ``(lo, hi)``: the buffer
    holds those experts only, and the entries routed elsewhere weigh
    zero (a model rank's partial sums)."""
    gates = r["gates"] if gates is None else gates
    T, K = gates.shape
    E = r["probs"].shape[1]
    e = r["e"].clamp_max(E - 1)
    w = gates * r["keep"].reshape(T, K)
    if experts is None:
        y = out_buf[_in_group(r["g"], e, E), r["slot"]]
    else:
        lo, hi = experts
        mine = (e >= lo) & (e < hi)
        y = out_buf[_in_group(r["g"], (e - lo).clamp(0, hi - lo - 1),
                              hi - lo), r["slot"]]
        w = w * mine.reshape(T, K)
    if masked and torch.is_grad_enabled():
        y = torch.where((r["e"] < E)[:, None], y, y.detach())
    w = w.to(y.dtype)
    return (y.reshape(T, K, -1) * w[..., None]).sum(dim=1)


def aux_loss(r: dict, E: int, groups: int = 1):
    """GShard load balance over the routed (pre-drop) entries, per group
    and then averaged over the groups: the counts drop the sentinel, but
    the divisor counts every entry of the group."""
    e = r["e"]
    counts = torch.zeros(groups * (E + 1), dtype=torch.float32,
                         device=e.device)
    counts.index_add_(0, _in_group(r["g"], e, E + 1),
                      torch.ones(e.shape, device=e.device))
    f = counts.view(groups, E + 1)[:, :E] / (e.numel() // groups)
    p = r["probs"].view(groups, -1, E).mean(dim=1)
    return E / groups * torch.sum(f * p)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
              capacity_factor: float = None, token_mask=None, tp=None,
              sp=None):
    """x: (B, S, d) -> (y (B, S, d), aux_loss f32 scalar).

    ``token_mask`` ((B, S) bool, optional): False marks pad/dummy tokens
    (right-padded serve prefill).  Masked tokens route to the sentinel
    expert id E, so they claim no capacity and take no slot in the
    buffer; their outputs are garbage (the gather reads expert E - 1, as
    the reference's clamping gather does), and callers only read unmasked
    positions.  Under ``tp`` the rank's experts, their partial sums
    all-reduced; under ``sp`` x is the rank's block of the sequence, its
    dispatch group (:func:`_moe_seq`)."""
    if sp is not None:
        return _moe_seq(params, x, cfg, act, capacity_factor, token_mask,
                        sp)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    GB, GS = _dispatch_groups(B, S)
    G, Bl, Sg = GB * GS, B // GB, S // GS
    capacity = capacity_of(Bl * Sg, cfg, capacity_factor)

    def grouped(t):
        # (B, S, ...) -> (G * Tg, ...): group (b, s) holds rows b of its
        # batch block and positions s of its sequence block
        rest = tuple(t.shape[2:])
        return t.reshape((GB, Bl, GS, Sg) + rest).transpose(1, 2).reshape(
            (B * S,) + rest)

    xt = grouped(x)
    mask = None if token_mask is None else grouped(token_mask)
    r = route(params, xt, cfg, capacity, mask, groups=G)
    # before the experts: the layer's last op is then the combine, which
    # a checkpoint's recompute skips (nothing after it is saved)
    aux = cfg.router_aux_weight * aux_loss(r, E, G)
    experts, gates, n = None, None, E
    if tp is not None:
        experts = tp.plan.experts
        n = experts[1] - experts[0]
        xt, gates = tp.enter(xt), tp.enter(r["gates"])
    buf = dispatch(xt, r, E, K, capacity, G, experts)
    # every group's slots of an expert in one batched product
    out = expert_ffn(params, buf.view(G, n, capacity, d).transpose(0, 1)
                     .reshape(n, G * capacity, d), act)
    out = out.reshape(n, G, capacity, d).transpose(0, 1)
    y = combine(out.reshape(G * n, capacity, d), r, token_mask is not None,
                gates, experts)
    y = y.reshape(GB, GS, Bl, Sg, d).transpose(1, 2).reshape(B, S, d)
    if tp is not None:
        y = tp.exit(y)
    return y, aux


def _moe_seq(params, x, cfg: MoEConfig, act: str, capacity_factor,
             token_mask, sp):
    """:func:`moe_apply` on the rank's block ``x`` (B, S/M, d), one
    dispatch group: the local route and scatter into the (E, C, d)
    buffer, ``sp.exchange_experts`` to the owners of its ``M`` blocks of
    experts, the rank's experts over the (M, E/M, C, d) slots it
    receives (every group's, group-major as world 1's product), the
    outputs exchanged back and combined locally."""
    B, S, d = x.shape
    E, K, M = cfg.n_experts, cfg.top_k, sp.M
    n = E // M
    capacity = capacity_of(B * S, cfg, capacity_factor)
    xt = x.reshape(B * S, d)
    mask = None if token_mask is None else token_mask.reshape(B * S)
    r = route(params, xt, cfg, capacity, mask)
    aux = cfg.router_aux_weight * aux_loss(r, E)
    buf = sp.exchange_experts(dispatch(xt, r, E, K, capacity))
    out = expert_ffn(params, buf.view(M, n, capacity, d).transpose(0, 1)
                     .reshape(n, M * capacity, d), act)
    out = sp.exchange_experts(out.view(n, M, capacity, d).transpose(0, 1)
                              .reshape(E, capacity, d))
    y = combine(out, r, token_mask is not None)
    return y.reshape(B, S, d), aux

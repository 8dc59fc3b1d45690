"""Mixture-of-Experts layer with capacity-based token-choice routing.  Port
of ``repro.models.moe``.

Top-k expert assignment with a static per-expert capacity: tokens are
scattered into a dense ``(E, capacity, d)`` buffer, the expert FFNs run as
one batched matmul against the stacked ``(E, d, ff)`` expert weights, and
the outputs are gathered back per token.  Tokens over capacity are
dropped; the aux load-balance loss keeps drops rare.  The reference also
computes this product outside any Pallas kernel, so the port has no
kernel here either.

There is one dispatch group (G = 1): the reference's ``_dispatch_groups``
returns that without a mesh, and the grouped all-to-all dispatch comes
with the distributed slice.  Every detail that decides which tokens an
expert takes follows the reference: the router in f32, top-k by k
iterated argmaxes (a tie goes to the first index), ranks by a stable sort
with masked tokens under a sentinel expert id E, the capacity counted over
the padded tokens, and the gather clamping the sentinel to E - 1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import DEFAULT_INIT_SCALE, dense_init


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


def route(params, xt, cfg: MoEConfig, capacity: int, token_mask=None):
    """Routing of the (T, d) tokens: router probabilities (T, E), the
    renormalised gates (T, K), and per (token, k) entry its expert id
    ``e`` (E for a masked token), its rank in that expert, whether it is
    kept and the buffer slot it reads."""
    E, K = cfg.n_experts, cfg.top_k
    T = xt.shape[0]
    probs, _ = router_probs(params, xt)                    # (T, E)
    gate_vals, expert_idx = _local_top_k(probs, K)         # (T, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1,
                                          keepdim=True).clamp_min(1e-9)
    if token_mask is not None:
        expert_idx = torch.where(token_mask.reshape(T, 1), expert_idx, E)
    e = expert_idx.reshape(T * K)
    rank = _ranks_in_expert(e, E)
    keep = rank < capacity
    return {"probs": probs, "gates": gate_vals, "e": e, "rank": rank,
            "keep": keep, "slot": torch.where(keep, rank, capacity - 1)}


def dispatch(xt, r: dict, E: int, K: int, capacity: int):
    """The (E, capacity, d) expert buffer.  The reference scatter-adds
    x * keep at (e, slot) and drops the sentinel rows; a dropped token adds
    zeros, so writing only the kept rows of real experts gives the same
    buffer bit for bit.  The other rows go to one spare row past the end,
    which is cut off: no mask of data-dependent length, so no wait for the
    device."""
    d = xt.shape[1]
    put = r["keep"] & (r["e"] < E)
    row = torch.where(put, r["e"] * capacity + r["rank"], E * capacity)
    buf = xt.new_zeros((E * capacity + 1, d))
    buf[row] = xt.repeat_interleave(K, dim=0)
    return buf[:-1].view(E, capacity, d)


def expert_ffn(params, buf, act: str):
    """Each expert's FFN over its slots: batched matmuls against the
    stacked (E, d, ff) weights."""
    h = torch.bmm(buf, params["up"])
    if act == "silu":
        h = F.silu(torch.bmm(buf, params["gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return torch.bmm(h, params["down"])


def combine(out_buf, r: dict, masked: bool):
    """(T, d): each token's kept expert outputs weighted by its gates.  The
    gather clamps the sentinel E to E - 1, as a JAX gather does; with a
    token mask its gradient drops the sentinel rows, as the JAX gather's
    transpose does."""
    E = out_buf.shape[0]
    T, K = r["gates"].shape
    y = out_buf[r["e"].clamp_max(E - 1), r["slot"]]
    if masked and torch.is_grad_enabled():
        y = torch.where((r["e"] < E)[:, None], y, y.detach())
    w = (r["gates"] * r["keep"].reshape(T, K)).to(y.dtype)
    return (y.reshape(T, K, -1) * w[..., None]).sum(dim=1)


def aux_loss(r: dict, E: int):
    """GShard load balance over the routed (pre-drop) entries: the counts
    drop the sentinel, but the divisor counts every entry."""
    e = r["e"]
    counts = torch.zeros(E + 1, dtype=torch.float32, device=e.device)
    counts.index_add_(0, e, torch.ones(e.shape, device=e.device))
    f = counts[:E] / e.numel()
    return E * torch.sum(f * r["probs"].mean(dim=0))


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
              capacity_factor: float = None, token_mask=None):
    """x: (B, S, d) -> (y (B, S, d), aux_loss f32 scalar).

    ``token_mask`` ((B, S) bool, optional): False marks pad/dummy tokens
    (right-padded serve prefill).  Masked tokens route to the sentinel
    expert id E, so they claim no capacity and take no slot in the
    buffer; their outputs are garbage (the gather reads expert E - 1, as
    the reference's clamping gather does), and callers only read unmasked
    positions."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    capacity = capacity_of(B * S, cfg, capacity_factor)
    xt = x.reshape(B * S, d)
    r = route(params, xt, cfg, capacity, token_mask)
    out_buf = expert_ffn(params, dispatch(xt, r, E, K, capacity), act)
    y = combine(out_buf, r, token_mask is not None)
    return y.reshape(B, S, d), cfg.router_aux_weight * aux_loss(r, E)

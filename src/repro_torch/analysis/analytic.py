"""Analytic per-chip cost model for the roofline (the port's copy of
``repro.analysis.analytic``).

The reference computes FLOPs, HBM bytes and collective bytes from first
principles because XLA's ``cost_analysis()`` counts a ``lax.scan`` body
once, not times its trip count.  The port has no XLA: the same arithmetic
stands beside what the port measures, the FLOPs that
``torch.utils.flop_counter.FlopCounterMode`` traces on the ``meta`` device
(:mod:`repro_torch.launch.dryrun`) and the device time that
``torch.profiler`` records on the card (:mod:`repro_torch.launch.perfprobe`).

Every formula is the reference's, term for term: the same inputs give the
same numbers.  Two things differ.  :func:`mesh_dims` reads an axis dict
such as ``{"data": 16, "model": 16}`` (the reference reads a JAX mesh's
``.shape``, which is that dict), and :func:`analytic_roofline`'s default
peaks are the card's (:data:`H100_PEAK_FLOPS`, :data:`H100_HBM_BW`,
:data:`H100_LINK_BW`), not the TPU v5e's.

All quantities are per-chip per-step.  Matmul FLOPs = 2*M*N*K.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

from repro_torch.configs.base import ArchConfig

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, NVIDIA's data sheet:
# dense bf16 tensor-core FLOP/s, HBM3 bytes/s, NVLink bytes/s per direction
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_LINK_BW = 450e9


@dataclasses.dataclass(frozen=True)
class MeshDims:
    pod: int = 1
    data: int = 16
    model: int = 16

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model


def mesh_dims(axes: Mapping[str, int]) -> MeshDims:
    """The mesh's axis sizes from an axis dict (``{"pod": 2, "data": 16,
    "model": 16}``; a missing axis is 1)."""
    d = dict(axes)
    return MeshDims(pod=d.get("pod", 1), data=d.get("data", 1),
                    model=d.get("model", 1))


def _dtype_bytes(cfg: ArchConfig) -> int:
    return 2 if "bf16" in cfg.param_dtype or "16" in cfg.param_dtype else 4


# --------------------------------------------------------------------------
def flops_forward(cfg: ArchConfig, batch: int, seq: int, kind: str,
                  window_override=None) -> float:
    """Global forward FLOPs for one step."""
    d = cfg.d_model
    tokens = batch * (1 if kind == "decode" else seq)

    # linear / matmul params: active params minus gather-only embedding;
    # tied embeddings still pay the logits matmul.
    n_lin = cfg.active_param_count() - cfg.vocab * d
    if cfg.tie_embeddings:
        n_lin += cfg.vocab * d
    if cfg.moe is not None:
        # capacity-based dispatch computes E*C slots ~= cf * T*K tokens
        n_moe_active = (cfg.n_layers // cfg.moe.every) * cfg.moe.top_k \
            * 3 * d * cfg.moe.expert_d_ff
        n_lin += n_moe_active * (cfg.moe.capacity_factor - 1.0)
    total = 2.0 * n_lin * tokens

    # attention score/value matmuls
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k == "attn")
    n_ssm = len(kinds) - n_attn
    window = window_override if window_override is not None else cfg.sliding_window
    if n_attn and cfg.n_heads:
        H, hd = cfg.n_heads, cfg.head_dim
        if kind == "decode":
            ctx = min(seq, window) if window else seq
            total += n_attn * 4.0 * batch * ctx * H * hd
        else:
            ctx = min(seq, window) if window else seq
            causal = 0.5 if (cfg.causal and ctx == seq) else 1.0
            total += n_attn * 4.0 * batch * seq * ctx * H * hd * causal

    # SSD terms
    if n_ssm and cfg.ssm is not None:
        s = cfg.ssm
        nh = s.n_heads(d)
        hp = s.head_dim
        gN = s.n_groups * s.d_state
        if kind == "decode":
            # recurrent update: h' = a h + dt x B ; y = C h
            total += n_ssm * batch * (4.0 * nh * hp * s.d_state)
        else:
            Q = min(s.chunk, seq)
            per_tok = (2.0 * Q * gN * 0.5            # C B^T (causal half)
                       + 2.0 * Q * nh * hp * 0.5     # M @ x
                       + 4.0 * nh * hp * s.d_state)  # inter-chunk + state
            total += n_ssm * batch * seq * per_tok
    return total


def flops_per_chip(cfg: ArchConfig, batch: int, seq: int, kind: str,
                   md: MeshDims, remat: bool = True,
                   window_override=None) -> float:
    fwd = flops_forward(cfg, batch, seq, kind, window_override)
    mult = 1.0
    if kind == "train":
        mult = 4.0 if remat else 3.0     # bwd = 2x fwd; remat adds 1x fwd
    return fwd * mult / md.chips


# --------------------------------------------------------------------------
def hbm_bytes_per_chip(cfg: ArchConfig, batch: int, seq: int, kind: str,
                       md: MeshDims, layout: str = "fsdp_tp") -> float:
    pb = _dtype_bytes(cfg)
    P = cfg.param_count() * pb
    d = cfg.d_model
    shards = md.chips if layout == "fsdp_tp" else md.model * 1  # dp: replicated
    if layout == "dp":
        shards = 1
    p_local = P / shards

    total = 0.0
    if kind == "train":
        # fwd + remat + bwd weight reads, grad write, optimizer read/write
        opt_mult = {"sgd": 0, "sgdm": 1, "adam": 2, "adamw": 2, "lamb": 2}[
            cfg.optimizer]
        total += p_local * (3          # weight reads (fwd, remat-fwd, bwd)
                            + 2        # grad write + read
                            + 2 * (1 + opt_mult))  # param + moments r/w
    else:
        total += p_local  # one streaming read of (local) weights

    # activations: ~6 bytes moved per element per layer boundary (read+write
    # through residual/norm/proj chain), batch sharded over (pod, data),
    # d sharded over model in fsdp_tp
    toks_local = batch * (1 if kind == "decode" else seq) / max(
        md.pod * md.data, 1)
    act_shard = md.model if layout == "fsdp_tp" else 1
    total += 6.0 * cfg.n_layers * toks_local * d * pb / act_shard * (
        3 if kind == "train" else 1)

    if kind == "decode":
        # KV cache / SSM state read+write — usually decode's dominant term
        total += decode_state_bytes(cfg, batch, seq) / md.chips * 2
    return total


def decode_state_bytes(cfg: ArchConfig, batch: int, seq: int) -> float:
    pb = _dtype_bytes(cfg)
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k == "attn")
    n_ssm = len(kinds) - n_attn
    total = 0.0
    if n_attn:
        cache = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        total += n_attn * 2 * batch * cache * cfg.n_kv_heads * cfg.head_dim * pb
    if n_ssm and cfg.ssm is not None:
        s = cfg.ssm
        nh = s.n_heads(cfg.d_model)
        total += n_ssm * batch * nh * s.head_dim * s.d_state * 4  # fp32 h
    return total


# --------------------------------------------------------------------------
def collective_bytes_per_chip(cfg: ArchConfig, batch: int, seq: int,
                              kind: str, md: MeshDims,
                              layout: str = "fsdp_tp") -> Dict[str, float]:
    """Per-chip collective traffic (ICI), by mechanism."""
    pb = _dtype_bytes(cfg)
    P = cfg.param_count() * pb
    d = cfg.d_model
    toks_local = batch * (1 if kind == "decode" else seq) / max(
        md.pod * md.data, 1)
    out: Dict[str, float] = {"fsdp_allgather": 0.0, "grad_reducescatter": 0.0,
                             "tp_allreduce": 0.0, "moe_alltoall": 0.0,
                             "pod_gradsync": 0.0}

    if layout == "dp":
        if kind == "train":
            # plain DP: ring all-reduce of full grads ~ 2*P per chip
            out["grad_reducescatter"] = 2.0 * P
        return out

    p_model_shard = P / md.model
    if kind == "train" and md.data > 1:
        ag = p_model_shard * (md.data - 1) / md.data
        out["fsdp_allgather"] = 2.0 * ag          # fwd + bwd gathers
        out["grad_reducescatter"] = ag            # RS of grads
        if md.pod > 1:
            out["pod_gradsync"] = 2.0 * (P / (md.data * md.model)) \
                * (md.pod - 1) / md.pod
    elif kind != "train" and md.data > 1:
        # weights stay sharded; no FSDP gather needed at batch>=data when
        # activations are model-sharded; count one gather for generality
        out["fsdp_allgather"] = 0.0

    passes = 4 if kind == "train" else 1          # fwd, remat, bwd(x2)
    if layout == "fsdp_sp" and md.model > 1:
        # sequence-parallel boundaries: norms/MLP/router local; per
        # attention layer one K/V gather at kv-head granularity (+ its
        # gradient reduction); per SSM layer only the segment-state
        # exchange (tiny) + conv halo.
        kinds = cfg.layer_kinds()
        n_attn = sum(1 for k in kinds if k == "attn")
        if n_attn and cfg.n_kv_heads:
            kv_bytes = (batch / max(md.pod * md.data, 1)) * seq \
                * 2 * cfg.n_kv_heads * cfg.head_dim * pb
            out["tp_allreduce"] = (n_attn * passes * kv_bytes
                                   * (md.model - 1) / md.model)
        n_ssm = len(kinds) - n_attn
        if n_ssm and cfg.ssm is not None:
            s = cfg.ssm
            state = (batch / max(md.pod * md.data, 1)) * s.n_heads(d) \
                * s.head_dim * s.d_state * 4
            out["tp_allreduce"] += n_ssm * passes * state * md.model
    elif md.model > 1:
        # tensor-parallel: one AR per mixer + one per ffn output, ring ~2
        n_ar = 2 * cfg.n_layers
        out["tp_allreduce"] = (n_ar * passes * 2.0 * toks_local * d * pb
                               * (md.model - 1) / md.model)

    if cfg.moe is not None and md.model > 1:
        n_moe = cfg.n_layers // cfg.moe.every
        mpasses = 3 if kind == "train" else 1
        # tokens cross expert shards twice (dispatch + combine).  Under
        # fsdp_sp the dispatch is chip-local-grouped: each chip exchanges
        # only ITS tokens (toks divided by model too); under fsdp_tp the
        # capacity buffer spans the model axis.
        toks_moe = toks_local / (md.model if layout == "fsdp_sp" else 1)
        out["moe_alltoall"] = (n_moe * mpasses * 2.0 * toks_moe
                               * cfg.moe.top_k * d * pb
                               * (md.model - 1) / md.model
                               * cfg.moe.capacity_factor)
    return out


# --------------------------------------------------------------------------
def analytic_roofline(cfg: ArchConfig, batch: int, seq: int, kind: str,
                      mesh, layout: str = "fsdp_tp", remat: bool = True,
                      window_override=None,
                      peak_flops: float = H100_PEAK_FLOPS,
                      hbm_bw: float = H100_HBM_BW,
                      link_bw: float = H100_LINK_BW) -> Dict:
    """The three terms, the dominant one and the bounds for one step of
    ``kind`` on ``mesh`` (an axis dict, see :func:`mesh_dims`)."""
    md = mesh_dims(mesh)
    fl = flops_per_chip(cfg, batch, seq, kind, md, remat, window_override)
    hb = hbm_bytes_per_chip(cfg, batch, seq, kind, md, layout)
    coll = collective_bytes_per_chip(cfg, batch, seq, kind, md, layout)
    coll_total = sum(coll.values())
    terms = {
        "compute_s": fl / peak_flops,
        "memory_s": hb / hbm_bw,
        "collective_s": coll_total / link_bw,
    }
    dominant = max(terms, key=terms.get)
    n_act = cfg.active_param_count()
    tokens = batch * (1 if kind == "decode" else seq)
    model_fl = (6.0 if kind == "train" else 2.0) * n_act * tokens / md.chips
    return {
        **terms,
        "dominant": dominant,
        "flops_per_chip": fl,
        "hbm_bytes_per_chip": hb,
        "collective_bytes_per_chip": coll_total,
        "collective_breakdown": coll,
        "model_flops_per_chip": model_fl,
        "useful_flops_ratio": model_fl / fl if fl else 0.0,
        "step_time_lower_bound_s": max(terms.values()),
        "mfu_upper_bound": model_fl / peak_flops / max(terms.values())
        if max(terms.values()) else 0.0,
    }

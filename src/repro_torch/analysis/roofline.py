"""Three-term roofline of a measured step (the port's counterpart of
``repro.analysis.roofline``).

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, from
NVIDIA's data sheet: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s
HBM3, 450 GB/s NVLink per direction.

The reference's ``roofline_terms`` reads XLA's ``cost_analysis()`` and the
partitioned HLO text of a compiled step; torch has neither.  Its
counterpart here, :func:`profile_terms`, takes what the port has: the
step's FLOPs and HBM bytes from the analytic model
(:mod:`repro_torch.analysis.analytic`), the collective bytes that
:class:`repro_torch.distributed.DistContext` counts where it issues them,
and the device time the probe measured.

    compute term    = FLOPs_per_chip / peak_FLOP/s
    memory term     = HBM_bytes_per_chip / HBM_bw
    collective term = collective_bytes_per_chip / link_bw
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.analysis.analytic import (H100_HBM_BW, H100_LINK_BW,
                                           H100_PEAK_FLOPS)


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-80gb-hbm3"
    peak_flops: float = H100_PEAK_FLOPS   # bf16 FLOP/s per card, dense
    hbm_bw: float = H100_HBM_BW           # bytes/s per card
    link_bw: float = H100_LINK_BW         # bytes/s per NVLink direction


HW = Hardware()


def model_flops(cfg, batch: int, seq: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = cfg.active_param_count()
    tokens = batch * (1 if kind == "decode" else seq)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def profile_terms(measured_s: float, flops: float, hbm_bytes: float,
                  collective_bytes: float, hw: Hardware = HW) -> Dict:
    """The three terms of one measured step on one card, the dominant
    term, the least time they allow (the largest term) and the measured
    time's share of it (``bound_share`` = least / measured: 1.0 is a step
    at the roofline; above 1.0 a count is wrong)."""
    terms = {"compute_s": flops / hw.peak_flops,
             "memory_s": hbm_bytes / hw.hbm_bw,
             "collective_s": collective_bytes / hw.link_bw}
    dominant = max(terms, key=terms.get)
    lower = terms[dominant]
    return {**terms, "dominant": dominant,
            "flops": flops, "hbm_bytes": hbm_bytes,
            "collective_bytes": collective_bytes,
            "step_time_lower_bound_s": lower, "measured_s": measured_s,
            "bound_share": lower / measured_s if measured_s else 0.0,
            "hardware": hw.name}

"""serve runner: adapts :func:`repro_torch.launch.serve.serve_main` (the
port's copy of ``repro.api.runners.serve``).

Two modes behind one kind: ``arrival_rate == 0`` (default) drains a
static batch through :class:`~repro_torch.serve.ServeEngine`;
``arrival_rate > 0`` drives the continuous-batching
:class:`~repro_torch.serve.ServeScheduler` with an open-loop ``trace``
(``poisson`` | ``bursty``), SLO shedding (``slo_deadline_ms``) and a
paged KV pool (``max_kv_blocks`` / ``kv_block_size``).  Either way the
report's metrics carry per-request service timing (TTFT / TPOT /
queue-wait percentiles, eviction count) so campaign summaries can
aggregate serving latency like any other contract metric.  The port's
own override ``device`` (default ``None``: ``cuda``, which must exist)
picks the torch device.
"""
from __future__ import annotations

import time

from repro_torch.api.report import RunReport
from repro_torch.api.registry import register_runner
from repro_torch.api.spec import RunSpec

DEFAULTS = {
    "requests": 16,
    "slots": 4,
    "cache_len": 128,
    "max_tokens": 16,
    "temperature": 0.0,
    "top_k": 0,
    # continuous-batching knobs (CLI: --arrival-rate, --slo-deadline-ms,
    # --max-kv-blocks; 0 means "off"/"auto" so the static path is the
    # default and every knob round-trips through overrides as a scalar)
    "arrival_rate": 0.0,
    "trace": "poisson",
    "slo_deadline_ms": 0.0,
    "max_kv_blocks": 0,
    "kv_block_size": 16,
    "device": None,           # torch device; None = cuda, which must exist
}


@register_runner("serve")
def run_serve(spec: RunSpec) -> RunReport:
    from repro_torch.launch.serve import serve_main
    o = spec.merged_overrides(DEFAULTS)
    t0 = time.time()
    result = serve_main(
        spec.arch, requests=int(o["requests"]), slots=int(o["slots"]),
        cache_len=int(o["cache_len"]), max_tokens=int(o["max_tokens"]),
        seed=spec.seed, temperature=float(o["temperature"]),
        top_k=int(o["top_k"]), arrival_rate=float(o["arrival_rate"]),
        trace=str(o["trace"]),
        slo_deadline_ms=float(o["slo_deadline_ms"]),
        max_kv_blocks=int(o["max_kv_blocks"]),
        kv_block_size=int(o["kv_block_size"]), device=o["device"])
    return RunReport(kind="serve", name=spec.run_name, metrics=result,
                     wall_s=round(time.time() - t0, 3),
                     spec=spec.to_dict())

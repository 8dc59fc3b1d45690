"""perfprobe runner: adapts :func:`repro_torch.launch.perfprobe.probe`
(the port's copy of ``repro.api.runners.perfprobe``).

The probe runs one (arch x shape) cell on the card at the batch the dry
run says fits it.  Its default ``layout`` is ``dp`` until ``sharding/``
is ported (the reference's is ``fsdp_tp``); ``fsdp_tp`` and ``fsdp_sp``
raise ``ValueError``.  One override is the port's own: ``device``
(default ``None``: ``cuda``, which must exist).
"""
from __future__ import annotations

import time

from repro_torch.api.report import RunReport
from repro_torch.api.registry import register_runner
from repro_torch.api.spec import RunSpec

DEFAULTS = {
    "shape": None,          # required
    "layout": "dp",
    "multi_pod": False,
    "microbatches": 1,
    "save": None,
    "device": None,         # torch device; None = cuda, which must exist
}


@register_runner("perfprobe")
def run_perfprobe(spec: RunSpec) -> RunReport:
    from repro_torch.launch.perfprobe import probe
    o = spec.merged_overrides(DEFAULTS)
    if not o["shape"]:
        raise ValueError("perfprobe requires a --shape override")
    t0 = time.time()
    rec = probe(spec.arch, o["shape"], o["layout"],
                multi_pod=bool(o["multi_pod"]),
                microbatches=int(o["microbatches"]), save=o["save"],
                device=o["device"], seed=spec.seed)
    return RunReport(kind="perfprobe", name=spec.run_name, metrics=rec,
                     wall_s=round(time.time() - t0, 3),
                     artifacts=(o["save"],) if o["save"] else (),
                     spec=spec.to_dict())

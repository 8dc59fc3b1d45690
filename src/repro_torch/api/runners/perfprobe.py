"""perfprobe runner: registered so ``kinds`` lists the reference's five
kinds.  The reference's probe reads XLA's compiled cost analysis
(``repro.launch.perfprobe``); that has no port yet, so the runner raises
and ``run perfprobe`` reports ``failed``.
"""
from __future__ import annotations

from repro_torch.api.report import RunReport
from repro_torch.api.registry import register_runner
from repro_torch.api.spec import RunSpec


@register_runner("perfprobe")
def run_perfprobe(spec: RunSpec) -> RunReport:
    raise NotImplementedError("the perfprobe kind reads XLA's cost "
                              "analysis and is not ported")

"""dryrun runner: registered so ``kinds`` lists the reference's five
kinds.  The reference's dryrun lowers every architecture against a
512-device XLA mesh (``repro.launch.dryrun``); that is XLA's work and has
no port yet, so the runner raises and ``run dryrun`` reports ``failed``.
"""
from __future__ import annotations

from repro_torch.api.report import RunReport
from repro_torch.api.registry import register_runner
from repro_torch.api.spec import RunSpec


@register_runner("dryrun")
def run_dryrun(spec: RunSpec) -> RunReport:
    raise NotImplementedError("the dryrun kind lowers through XLA and is "
                              "not ported")

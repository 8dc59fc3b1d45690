"""dryrun runner: the dry run on the ``meta`` device as a Runner
(the port's copy of ``repro.api.runners.dryrun``).

``spec.arch`` may be a single arch, a comma list, or ``"all"``.  Each
(arch x shape) step is built and run on ``meta``
(:func:`repro_torch.launch.dryrun.run_one`): nothing is allocated on any
device.  ``layout`` and ``mesh`` choose the reference mesh (default
``fsdp_tp`` on one pod, as in the reference): each record's analytic
roofline and its ``rank`` section, one rank of that mesh traced under
the layout.  The one-card fields describe world 1 under ``dp``.  The
report's ``results`` carry each record's rank section but its FLOPs by
operator.
"""
from __future__ import annotations

import time

from repro_torch.api.report import FAILED, RunReport, SUCCEEDED
from repro_torch.api.registry import register_runner
from repro_torch.api.spec import RunSpec

DEFAULTS = {
    "shape": "all",
    "mesh": "single",       # single | multi | both
    "layout": "fsdp_tp",
    "microbatches": 1,
    # the reference's records go to experiments/dryrun, under the same names
    "out": "experiments/dryrun_torch",
}


@register_runner("dryrun")
def run_dryrun(spec: RunSpec) -> RunReport:
    from repro_torch.launch.dryrun import dryrun_sweep
    from repro_torch.launch.mesh import INPUT_SHAPES

    o = spec.merged_overrides(DEFAULTS)
    if o["mesh"] not in ("single", "multi", "both"):
        raise ValueError(f"mesh must be single|multi|both, got {o['mesh']!r}")
    if o["shape"] != "all" and o["shape"] not in INPUT_SHAPES:
        raise ValueError(f"unknown shape {o['shape']!r} "
                         f"(have {list(INPUT_SHAPES)})")

    t0 = time.time()
    results = dryrun_sweep(
        archs=spec.arch, shapes=o["shape"], meshes=o["mesh"],
        layout=o["layout"], microbatches=int(o["microbatches"]),
        out=o["out"])
    counts = {"ok": 0, "skipped": 0, "error": 0}
    for rec in results:
        counts[rec["status"]] = counts.get(rec["status"], 0) + 1
    metrics = {
        "cells": len(results),
        **counts,
        "results": [{k: r.get(k) for k in (
            "arch", "shape", "mesh", "layout", "status", "traced",
            "traced_flops", "traced_over_analytic", "bytes",
            "peak_bytes", "fits_one_card", "max_batch_one_card",
            "peak_bytes_one_card")} | {"rank": {
                k: v for k, v in (r.get("rank") or {}).items()
                if k != "traced_flops_by_op"} or None}
            for r in results],
    }
    if counts["error"]:
        metrics["errors"] = [
            {"arch": r["arch"], "shape": r["shape"], "error": r["error"]}
            for r in results if r["status"] == "error"]
    artifacts = tuple(
        f"{o['out']}/{r['arch']}_{r['shape']}_{r['mesh']}_{r['layout']}.json"
        for r in results) if o["out"] else ()
    return RunReport(
        kind="dryrun", name=spec.run_name,
        status=FAILED if counts["error"] else SUCCEEDED,
        error=(f"{counts['error']}/{len(results)} cells failed"
               if counts["error"] else None),
        metrics=metrics, wall_s=round(time.time() - t0, 3),
        artifacts=artifacts, spec=spec.to_dict())

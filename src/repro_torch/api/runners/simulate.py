"""simulate runner (the port's copy of ``repro.api.runners.simulate``):
campaign expansion -> manifests -> cluster-sim accounting (the paper's
Tables III/V bottom lines), through the Orchestrator.  Pure Python: no
torch is imported and no device is used.
"""
from __future__ import annotations

import time

from repro_torch.api.report import RunReport
from repro_torch.api.registry import register_runner
from repro_torch.api.spec import RunSpec

DEFAULTS = {
    "campaign": "burned_area",   # burned_area | detection | deforestation | all
    "mode": "simulate",          # simulate | manifests
    "workdir": "experiments/campaigns",
    "preemption_rate": 0.0,      # per-attempt preemption probability
    "checkpoint_every_h": 0.0,   # durable-checkpoint cadence (0 = restart
                                 # from scratch on preemption)
    "placement": "best_fit",     # best_fit | worst_fit | pack
}

CAMPAIGNS = ("burned_area", "detection", "deforestation")


@register_runner("simulate")
def run_simulate(spec: RunSpec) -> RunReport:
    from repro_torch.core import Orchestrator, PersistentVolume, S3Store
    from repro_torch.launch.submit import build_campaign_runs

    o = spec.merged_overrides(DEFAULTS)
    if o["mode"] not in ("simulate", "manifests"):
        raise ValueError(f"mode must be simulate|manifests, got {o['mode']!r}")
    names = CAMPAIGNS if o["campaign"] == "all" else (o["campaign"],)
    t0 = time.time()
    runs = []
    for n in names:
        runs.extend(build_campaign_runs(n))

    pvc = PersistentVolume(o["workdir"], name=f"campaign-{o['campaign']}")
    orch = Orchestrator(pvc, S3Store(o["workdir"]))
    orch.submit_runs(runs)
    n_manifests = len(pvc.listdir("manifests"))
    print(f"submitted {len(runs)} jobs; {n_manifests} manifests rendered")

    metrics = {"jobs": len(runs), "manifests": n_manifests}
    if o["mode"] == "simulate":
        res = orch.simulate(preemption_rate=float(o["preemption_rate"]),
                            checkpoint_every_h=float(o["checkpoint_every_h"]),
                            placement=o["placement"])
        metrics.update({
            "total_gpu_hours": round(res.total_gpu_hours, 1),
            "total_wall_hours": round(res.total_wall_hours, 1),
            "cluster_makespan_h": round(res.makespan_h, 2),
            "speedup_vs_serial": round(res.speedup_vs_serial(), 1),
            "mean_queue_wait_h": round(res.queue_wait_h_mean, 3),
            "placement": o["placement"],
            "busy_utilization": round(res.busy_utilization, 4),
            "goodput_utilization": round(res.goodput_utilization, 4),
        })
        if float(o["preemption_rate"]) > 0:
            metrics.update({
                "preemptions": res.preemptions,
                "lost_gpu_hours": round(res.lost_gpu_hours, 1),
                "goodput": round(res.goodput, 4),
            })
    return RunReport(kind="simulate", name=spec.run_name, metrics=metrics,
                     wall_s=round(time.time() - t0, 3),
                     artifacts=(str(pvc.root / "manifests"),),
                     spec=spec.to_dict())

"""perfprobe runner: adapts :func:`repro_torch.launch.perfprobe.probe`
(the port's copy of ``repro.api.runners.perfprobe``).

The probe runs one (arch x shape) cell on the card at the batch the dry
run says fits it.  Its default ``layout`` is the reference's,
``fsdp_tp``.  Three branches, as ``run train``'s: ``world_size > 1``
without ``dist_rank`` self-gangs (:func:`repro_torch.distributed.gang.
run_gang_local` spawns one ``run perfprobe`` process per rank and adopts
rank 0's report, every rank's ``dist`` section under ``gang``); with
``dist_rank`` (and ``coordinator``) this process is one rank of the
grid ``{pod: pod, data: world_size / (pod * model), model: model}``
(:func:`repro_torch.sharding.grid.model_grid`); otherwise world 1, where
every layout is the ``dp`` step.  ``multi_pod`` traces one rank of the
reference's two-pod mesh on ``meta`` and runs nothing (no card needed).
The port's own overrides: ``device`` (default
``None``: ``cuda``, which must exist), ``reduced``, ``batch`` and
``seq`` for a cut of the cell (the CPU tests run the reduced config;
``chip_smoke.py`` a gang at phase 25's batch), and ``model``, the
grid's model extent (``fsdp_tp`` and ``fsdp_sp``; ``dp`` on a model axis
raises), and ``pod``, its pod extent (the pods are replicas: the batch
splits over ``(pod, data)``).
"""
from __future__ import annotations

import json
import os
import time

from repro_torch.api.report import RunReport
from repro_torch.api.registry import register_runner
from repro_torch.api.spec import RunSpec

DEFAULTS = {
    "shape": None,          # required
    "layout": "fsdp_tp",
    "multi_pod": False,
    "microbatches": 1,
    "save": None,
    "device": None,         # torch device; None = cuda, which must exist
    "reduced": False,       # the arch's reduced config
    "batch": None,          # global batch; None = the dry run's cut
    "seq": None,            # None = the shape's sequence
    "world_size": 1,        # >1 = a gang of ranks on a {data, model} grid
    "model": 1,             # the grid's model extent (divides world_size)
    "pod": 1,               # the grid's pod extent (divides world_size)
    "dist_rank": None,      # set per rank by the gang launcher
    "coordinator": None,    # rank 0's host:port
}


def _int(v):
    return None if v is None else int(v)


@register_runner("perfprobe")
def run_perfprobe(spec: RunSpec) -> RunReport:
    o = spec.merged_overrides(DEFAULTS)
    if not o["shape"]:
        raise ValueError("perfprobe requires a --shape override")
    t0 = time.time()
    world = int(o["world_size"] or 1)
    if world % (int(o["model"]) * int(o["pod"])):
        raise ValueError(f"model {o['model']} x pod {o['pod']} does not "
                         f"divide world_size {world}")
    if world > 1 and o["dist_rank"] is None:
        from repro_torch.distributed.gang import run_gang_local
        rec = run_gang_local(spec, world)
        if o["save"]:
            os.makedirs(os.path.dirname(o["save"]) or ".", exist_ok=True)
            with open(o["save"], "w") as f:
                json.dump(rec, f, indent=1, default=str)
    else:
        rec = _one_rank(spec, o, world)
    return RunReport(kind="perfprobe", name=spec.run_name, metrics=rec,
                     wall_s=round(time.time() - t0, 3),
                     artifacts=(o["save"],) if o["save"] else (),
                     spec=spec.to_dict())


def _one_rank(spec: RunSpec, o: dict, world: int) -> dict:
    """World 1, or this process as rank ``dist_rank`` of a gang."""
    from repro_torch.launch.perfprobe import probe
    kw = dict(multi_pod=bool(o["multi_pod"]),
              microbatches=int(o["microbatches"]), save=o["save"],
              seed=spec.seed, reduced=bool(o["reduced"]),
              batch=_int(o["batch"]), seq=_int(o["seq"]))
    if o["dist_rank"] is None:
        if kw["multi_pod"]:      # traced on meta: no device
            return probe(spec.arch, o["shape"], o["layout"], **kw)
        return probe(spec.arch, o["shape"], o["layout"], device=o["device"],
                     **kw)
    from repro_torch.distributed.context import init_distributed
    from repro_torch.sharding.grid import model_grid
    ctx = init_distributed(world, int(o["dist_rank"]), o["coordinator"],
                           o["device"])
    try:
        return probe(spec.arch, o["shape"], o["layout"],
                     grid=model_grid(ctx, int(o["model"]), int(o["pod"])),
                     **kw)
    finally:
        ctx.close()

"""The burned-area hyperparameter grid: the paper's Sect. III-B workflow
run end to end through the orchestration layer.  Port of
``examples/burned_area_grid.py``.

    python -m repro_torch.launch.vision_grid [--device cpu]

Synthetic Sentinel-2 scenes, normalized on the device (the hand-written
kernel K5 on a card, :func:`repro_torch.launch.vision.build_dataset`) ->
25%-overlap chipping -> an ``ExperimentGrid`` of (lr x optimizer) U-Net
jobs -> ``Orchestrator.run_local`` (manifests, retries, PVC staging, S3
export) -> the best config by val F1 -> the cluster simulation of the
same jobs.  Each job's payload is
:func:`repro_torch.launch.vision.train_segmentation` of the U-Net, its
``lr``, ``optimizer`` and ``init_seed`` from the job's env, as the
example's ``train_unet`` reads them.  Runs on ``cuda`` unless
``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from typing import Callable, Optional

from repro_torch.core import (ExperimentGrid, JobSpec, Orchestrator,
                              PersistentVolume, Resources, S3Store)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.percentile_norm.kernel import percentile_norm_kernel
from repro_torch.launch.vision import build_dataset, train_segmentation

# the example's grid, resources, simulated duration and labels
GRID = ("ba-unet", {"lr": [1e-2, 1e-3, 1e-4], "optimizer": ["adam", "lamb"]})
RESOURCES = Resources(gpus=2, cpus=4, memory_gb=24)
DURATION_H = 518.0 / 144
LABELS = {"experiment": "ba-grid"}
# the example's U-Net: width 8, batches of 4, 4 epochs
WIDTH, BATCH, EPOCHS = 8, 4, 4


def make_payload(split: dict, *, device, width: int = WIDTH,
                 batch: int = BATCH, epochs: int = EPOCHS) -> Callable:
    """The jobs' payload: the U-Net trained on ``split``'s train chips
    and scored on its val chips (``train_segmentation``), ``lr``,
    ``optimizer``, ``init_seed`` and ``epochs`` from the job's env.
    Returns the val metrics, the steps and the wall seconds."""
    def train_unet(lr="1e-3", optimizer="adam", init_seed="0",
                   epochs=str(epochs), **kw):
        t0 = time.perf_counter()
        res = train_segmentation("unet", split, lr=float(lr),
                                 optimizer=optimizer, epochs=int(epochs),
                                 batch=batch, width=width, device=device,
                                 seed=int(init_seed))
        keep = {k: v for k, v in res.items()
                if k not in ("model", "params", "losses", "chips_seen",
                             "first_step_s")}
        return dict(keep, final_loss=res["losses"][-1],
                    wall_s=time.perf_counter() - t0)
    return train_unet


def _job(spec, payload: Callable) -> JobSpec:
    return JobSpec(name=spec.name, payload=payload,
                   env={k: str(v) for k, v in spec.params.items()},
                   resources=RESOURCES, duration_h=DURATION_H,
                   labels=dict(LABELS))


def job_record(job: JobSpec) -> dict:
    """What a job asks of the cluster: its name, env, resources,
    simulated duration and labels."""
    return {"name": job.name, "env": job.env,
            "resources": dataclasses.asdict(job.resources),
            "duration_h": job.duration_h, "labels": job.labels}


def run_grid(split: dict, *, device=None, width: int = WIDTH,
             batch: int = BATCH, epochs: int = EPOCHS, workdir: str,
             payload: Optional[Callable] = None) -> dict:
    """The example's grid on ``split``: each experiment's config staged
    on a ``PersistentVolume`` at ``workdir``, its job submitted to an
    ``Orchestrator`` (S3 export to ``workdir`` too) and run by
    ``run_local``; ``payload`` (default :func:`make_payload`'s) trains
    each.  Returns the specs, the jobs, the orchestrator's summary, each
    job's state and result, the configs ranked by val F1, the best, and
    the simulated makespan and speedup over a serial run."""
    if payload is None:
        payload = make_payload(split, device=resolve_device(device),
                               width=width, batch=batch, epochs=epochs)
    specs = ExperimentGrid(*GRID).expand()
    pvc, s3 = PersistentVolume(workdir), S3Store(workdir)
    orch = Orchestrator(pvc, s3)
    for spec in specs:
        pvc.stage_bytes(f"configs/{spec.name}.json",
                        spec.config_json().encode())
        orch.submit(_job(spec, payload))
    orch.run_local()
    results = {name: rec.result for name, rec in orch.records.items()}
    done = [n for n, r in results.items() if r is not None]
    ranking = sorted(done, key=lambda n: -results[n]["f1"])
    sim = orch.simulate()
    return {"specs": [{"name": s.name, "params": s.params} for s in specs],
            "jobs": [job_record(r.spec) for r in orch.records.values()],
            "summary": orch.summary(),
            "states": {n: r.state.value for n, r in orch.records.items()},
            "results": results, "ranking": ranking,
            "best": max(done, key=lambda n: results[n]["f1"])
            if done else None,
            "makespan_h": sim.makespan_h,
            "speedup_vs_serial": sim.speedup_vs_serial()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n0 = percentile_norm_kernel.launches
    split = build_dataset(device=device)
    with tempfile.TemporaryDirectory() as td:
        out = run_grid(split, device=device, workdir=td)
    out = {"device": str(device),
           "chips": {k: len(v) for k, v in split.items()}, **out,
           "percentile_norm_launches": percentile_norm_kernel.launches - n0}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

"""Campaign submission CLI (the port's copy of ``repro.launch.submit``) —
the paper's bash automation as a library command: expand a grid into
:class:`repro_torch.api.RunSpec`s, render every manifest + config, then
simulate the campaign on the Nautilus inventory (or just emit the
manifests).

``python -m repro_torch.launch.submit --campaign burned_area --mode simulate``

is a thin shim over ``python -m repro_torch.launch run simulate ...``:
campaigns are lists of RunSpecs, jobs and manifests fall out of
``Orchestrator.submit_runs``, and the accounting matches the paper's
Tables III/V (144 burned-area models; 2,142 detection wall-hours).
"""
from __future__ import annotations

import argparse
import json
from typing import List

from repro_torch.api import RunSpec
from repro_torch.core import JobSpec, Resources
from repro_torch.core.experiment import paper_burned_area_grid

# Table V rows this module reproduces
BURNED_AREA_TOTAL_H = 518.0          # over 144 models
DETECTION_TOTAL_H = 2142.0           # over 30 models
DEFORESTATION_TOTAL_H = 1380.0       # over 60 models

DETECTION_MODELS = ["convnext", "ssd", "retinanet", "fcos", "yolov3",
                    "yolox", "vit", "detr", "deformable-detr", "swin"]
# Table III GPU-hour ratios, used to apportion Table V's wall-clock total
DETECTION_DATASET_GPU_H = {"rareplanes": 241.2, "dota": 580.4,
                           "xview": 580.6}


def build_campaign_runs(name: str) -> List[RunSpec]:
    """A campaign as RunSpecs — the single declarative form every
    consumer (manifests, local runs, cluster sim) now starts from."""
    if name == "burned_area":
        runs: List[RunSpec] = []
        for arch, grid in paper_burned_area_grid().items():
            runs.extend(grid.to_runs(
                kind="train", arch=arch,
                resources=Resources(gpus=2, cpus=4, memory_gb=24),
                duration_h=BURNED_AREA_TOTAL_H / 144,
                labels={"experiment": f"ba-{arch}"}))
        return runs
    if name == "detection":
        scale = DETECTION_TOTAL_H / sum(DETECTION_DATASET_GPU_H.values())
        return [
            RunSpec(kind="train", arch=m, name=f"det-{m}-{ds}",
                    overrides={"model": m, "dataset": ds},
                    resources=Resources(gpus=4, cpus=8, memory_gb=48),
                    duration_h=gpu_h / len(DETECTION_MODELS) * scale,
                    labels={"experiment": "detection"})
            for m in DETECTION_MODELS
            for ds, gpu_h in DETECTION_DATASET_GPU_H.items()]
    if name == "deforestation":
        return [
            RunSpec(kind="train", arch="changeformer", name=f"cf-{i}",
                    overrides={"config": i},
                    resources=Resources(gpus=1, cpus=4, memory_gb=24),
                    duration_h=DEFORESTATION_TOTAL_H / 60,
                    labels={"experiment": "deforestation"})
            for i in range(60)]
    raise ValueError(name)


def build_campaign(name: str) -> List[JobSpec]:
    """Back-compat: the campaign as cluster JobSpecs."""
    return [run.to_job() for run in build_campaign_runs(name)]


def main(argv=None):
    # thin shim over the repro_torch.api registry (RunSpec in, RunReport out)
    ap = argparse.ArgumentParser()
    ap.add_argument("--campaign", default="burned_area",
                    choices=["burned_area", "detection", "deforestation",
                             "all"])
    ap.add_argument("--mode", default="simulate",
                    choices=["simulate", "manifests"])
    ap.add_argument("--workdir", default="experiments/campaigns")
    args = ap.parse_args(argv)

    from repro_torch.api import run
    report = run(RunSpec(kind="simulate", overrides={
        "campaign": args.campaign, "mode": args.mode,
        "workdir": args.workdir}))
    if not report.ok:
        raise SystemExit(report.error or 1)
    if args.mode == "simulate":
        out = {k: v for k, v in report.metrics.items() if k != "manifests"}
        print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

"""Run one (arch x shape) cell on the card and measure it (the port's
counterpart of ``repro.launch.perfprobe``).

    python -m repro_torch.launch.perfprobe --arch stablelm-1.6b --shape train_4k

The reference lowers and compiles a cell for the production TPU mesh and
reports XLA's collective bytes and temp memory beside the analytic
roofline.  The port runs the cell: one warm-up step, one measured step
(host clock around a synchronize) and, at world 1, one step under
``torch.profiler``.
``INPUT_SHAPES`` are pod-sized, so the batch is cut to what one card holds:
the dry run's ``max_batch_one_card`` (:mod:`repro_torch.launch.dryrun`);
the sequence is never cut.  A train cell builds ``init_train_state``'s
state and ``make_train_step``'s step, a prefill cell ``prefill``, a decode
cell ``decode_step`` on a cache of ``seq`` (:mod:`repro_torch.launch.
steps`).  The record holds the step's time, the device profile (the
longest ops, K1-K4's ms and calls, busy and idle, peak memory), K1-K4's
launches by route in the
measured step, the all-reduce bytes (0: world 1 issues no collective),
:func:`analytic_roofline` for one chip, and :func:`profile_terms`, the
measured device time against the analytic FLOPs and bytes.

A grid of ranks (``grid``, a :class:`repro_torch.sharding.grid.RankGrid`
on ``{pod: P, data: D, model: M}``: the runner's ``world_size`` self-gangs
as ``run train`` does, its ``model`` is M and its ``pod`` P) runs the
cell as a gang, the global batch split over the grid's batch group
(``(pod, data)``; the pods are replicas whose gradients are summed, the
mechanism ``pod_gradsync``):
``fsdp_tp`` and ``fsdp_sp`` keep each rank's shards of the parameters
and moments and gather each layer where it runs (on the data axis the
reference's rules make both ZeRO-3), ``fsdp_tp`` on a model axis
computes each rank's heads, experts and vocabulary rows
(:mod:`repro_torch.sharding.tp`), ``fsdp_sp`` on a model axis each
rank's block of the sequence in training and prefill (an MoE slot's
experts exchanged by all-to-all) and its blocks of the decode state in
decode (:mod:`repro_torch.sharding.sp`), and ``dp`` is the
data-parallel gang.
Each rank adds a ``dist`` section: its collective bytes in the measured
step by the analytic model's mechanism (``fsdp_allgather``,
``grad_reducescatter``, ``tp_allreduce``, ``moe_alltoall``, and the
port's ``replicated_allreduce``, ``norm_allreduce``, ``tp_weights``,
``vocab_allgather``, and under ``fsdp_sp`` ``kv_allgather``,
``ssd_state_allgather``, ``conv_halo``, ``sp_allgather``,
``sp_reducescatter``, and in decode ``softmax_combine`` and
``conv_allgather``), the port's own count from the shapes
(``tp_allreduce_shape_bytes``; under ``fsdp_sp`` ``sp_shape_bytes``, by
mechanism, and ``sp_vs_analytic``: the analytic model's ``fsdp_sp``
``tp_allreduce``, one K/V gather an attention layer and one state
exchange an SSM layer, beside the measured ``kv_allgather +
ssd_state_allgather``, and its ``moe_alltoall`` beside the measured),
its peak memory, launches and losses, and in a train step on a pod
axis ``pod_gradsync_shape_bytes``; the record holds
:func:`collective_bytes_per_chip` for ``{pod: P, data: D, model: M}``
beside them.  On a grid of one rank every layout is the ``dp`` step.

The reference's two-pod mesh (``multi_pod``) is 512 cards, which no host
holds; the reference's probe compiles a cell for it and runs nothing.
So does the port's: ``multi_pod`` without a grid traces one rank of that
mesh on ``meta`` (:func:`repro_torch.launch.dryrun.rank_section`) at
the cell's global batch and returns the per-chip fields, its collective
bytes by mechanism and in all, the bytes it holds and its peak, with
``"measured_on": "meta"``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, Optional

import torch

from repro_torch.analysis.analytic import (analytic_roofline,
                                           collective_bytes_per_chip,
                                           mesh_dims)
from repro_torch.analysis.profile import device_profile
from repro_torch.analysis.roofline import profile_terms
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.ssd_scan import kernel as ssd
from repro_torch.launch.dryrun import (one_card_budget, one_card_fit,
                                       peak_at, rank_section, trace_step)
from repro_torch.launch.mesh import INPUT_SHAPES, mesh_tag, production_dims
from repro_torch.launch.steps import build, effective_config
from repro_torch.sharding.sp import sp_bytes
from repro_torch.sharding.tp import tp_allreduce_bytes

LAYOUTS = ("dp", "fsdp_tp", "fsdp_sp")
ONE_CARD = {"data": 1, "model": 1}
# the launch counters of K1-K4, by the names chip_smoke.py prints
KERNELS = {"flash_attention_fwd": fa.flash_attention_fwd_kernel,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_kernel,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_kernel,
           "ssd_scan": ssd.ssd_scan_kernel}
# what each kernel's CUDA entry points are called in a profiler trace
TRACE_NAMES = {"flash_attention_fwd": "flash_fwd_",
               "flash_attention_bwd_dq": "flash_bwd_dq_",
               "flash_attention_bwd_dkv": "flash_bwd_dkv_",
               "ssd_scan": "ssd_scan_"}


def _launches() -> Dict[str, Dict[str, int]]:
    return {name: dict(fn.launches_by_route) for name, fn in KERNELS.items()}


def _kernel_ms(kernels: Dict[str, Dict]) -> Dict[str, Dict]:
    """K1-K4's device ms and calls in a profile's ``kernels``."""
    out = {}
    for name, part in TRACE_NAMES.items():
        rows = [v for key, v in kernels.items() if part in key]
        out[name] = {"ms": sum(r["ms"] for r in rows),
                     "calls": sum(r["calls"] for r in rows)}
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dist_record(grid, before: Dict, launches: Dict, step_s: float,
                 losses) -> Dict:
    """A gang rank's own measurements of the measured step."""
    d = grid.dist
    return {"rank": d.rank, "world_size": d.world_size, "grid": grid.mesh,
            "backend": d.backend, "device": str(d.device),
            "collective_bytes": {k: v - before.get(k, 0.0)
                                 for k, v in d.collective_bytes.items()},
            "step_s": step_s, "kernel_launches": launches,
            "losses": losses}


def _outcome(kind: str, out) -> Dict:
    """The step's loss (train) or whether its logits are finite."""
    if kind == "train":
        loss = float(out[1]["loss"])
        return {"loss": loss, "finite": math.isfinite(loss)}
    logits = out[0] if isinstance(out, tuple) else out
    return {"logits_shape": list(logits.shape),
            "finite": bool(torch.isfinite(logits.float()).all())}


def probe(arch: str, shape: str, layout: str = "dp", *,
          multi_pod: bool = False, microbatches: int = 1,
          save: Optional[str] = None, device=None, seed: int = 0,
          reduced: bool = False, batch: Optional[int] = None,
          seq: Optional[int] = None, grid=None) -> dict:
    """One cell on ``device`` (default ``cuda``, which must exist), or on
    ``grid``'s rank (its device) as one rank of a gang.

    ``batch`` (the GLOBAL batch of a gang) and ``seq`` default to the dry
    run's one-card batch and the shape's sequence; ``reduced`` takes the
    arch's reduced config.  The record names whatever cut was taken.
    ``multi_pod`` (the reference's two-pod mesh) traces one rank of it
    on ``meta`` (:func:`meta_rank_probe`) and runs nothing.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (have {LAYOUTS})")
    if multi_pod:
        if grid is not None:
            raise ValueError("a gang runs on its own grid; multi_pod traces "
                             "one rank of the two-pod mesh on meta")
        return meta_rank_probe(arch, shape, layout, microbatches=microbatches,
                               save=save, reduced=reduced, batch=batch,
                               seq=seq)
    seq_of, batch_of, kind = INPUT_SHAPES[shape]
    world = 1 if grid is None else grid.world_size
    rows_of = 1 if grid is None else grid.group("batch").size
    step_layout = layout if world > 1 else "dp"
    device = grid.device if grid is not None else resolve_device(device)
    cfg = effective_config(get_reduced(arch) if reduced else get_config(arch),
                           shape)
    seq = seq or seq_of
    one_card = None
    if batch is None:
        traced = trace_step(kind, cfg, batch_of, seq, microbatches)
        fits, batch = one_card_fit(traced, batch_of)
        if not batch:
            raise ValueError(f"{arch} x {shape}: even batch 1 does not fit "
                             f"one card (peak {traced['peak_bytes']} bytes "
                             f"at batch {batch_of})")
        # the peak at the cut, traced there too, to read beside the card's
        at_cut = trace_step(kind, cfg, batch, seq, microbatches)
        one_card = {"estimate_bytes": traced["bytes"],
                    "fits_at_batch_of": fits, "max_batch_one_card": batch,
                    "estimate_peak_bytes": peak_at(traced, batch_of, batch),
                    "traced_peak_bytes": at_cut["peak_bytes"],
                    "budget_bytes": one_card_budget()}
    if batch % rows_of:
        raise ValueError(f"global batch {batch} does not divide over "
                         f"{rows_of} ranks of (pod, data)")
    kw = {"microbatches": microbatches} if kind == "train" else {}
    t0 = time.time()
    fn, args = build(kind, cfg, batch, seq, device=device, seed=seed,
                     layout=layout, grid=grid, **kw)
    _sync(device)
    build_s = time.time() - t0

    losses = []       # a train cell's loss at each step it runs

    def run():
        out = fn(*args)
        if kind == "train":
            losses.append(float(out[1]["loss"]))
        return out

    t0 = time.time()
    out = run()
    _sync(device)
    warmup_s = time.time() - t0
    del out
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = _launches()
    bytes_before = {} if grid is None else dict(grid.dist.collective_bytes)
    allreduce_before = 0 if grid is None else grid.dist.allreduce_bytes
    t0 = time.time()
    out = run()
    _sync(device)
    step_s = time.time() - t0
    after = _launches()
    outcome = _outcome(kind, out)
    del out
    launches = {name: {r: after[name][r] - before[name][r]
                       for r in after[name]} for name in KERNELS}
    dist = None
    mesh = ONE_CARD if world == 1 else {
        "pod": grid.extent("pod"), "data": grid.extent("data"),
        "model": grid.extent("model")}
    if world > 1:
        dist = _dist_record(grid, bytes_before, launches, step_s, losses)
        esize = getattr(torch, cfg.param_dtype).itemsize
        dist["tp_allreduce_shape_bytes"] = (tp_allreduce_bytes(
            cfg, batch // rows_of, seq, kind, mesh["model"], esize)
            if step_layout == "fsdp_tp" else 0.0)
        fsdp = getattr(fn, "fsdp", None)
        if fsdp is not None and mesh["pod"] > 1:
            dist["pod_gradsync_shape_bytes"] = fsdp.pod_gradsync_bytes(
                args[0].params)
        if step_layout == "fsdp_sp" and mesh["model"] > 1:
            dist["sp_shape_bytes"] = sp_bytes(cfg, batch // rows_of, seq,
                                              kind, mesh["model"], esize)
            got = dist["collective_bytes"]
            analytic = collective_bytes_per_chip(
                cfg, batch, seq, kind, mesh_dims(mesh), "fsdp_sp")
            dist["sp_vs_analytic"] = {
                "analytic_tp_allreduce": analytic["tp_allreduce"],
                "kv_allgather + ssd_state_allgather": (
                    got.get("kv_allgather", 0.0)
                    + got.get("ssd_state_allgather", 0.0)),
                "analytic_moe_alltoall": analytic["moe_alltoall"],
                "moe_alltoall": got.get("moe_alltoall", 0.0)}
    profile = None
    peak_gb = None
    if device.type == "cuda":
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    if device.type == "cuda" and world == 1:
        # a gang's ranks may share the card: one rank's trace would not
        # be the card's busy time, so a gang runs no profiled step
        profile = device_profile(run)
        profile["kernel_ms"] = _kernel_ms(profile.pop("kernels"))
    analytic = analytic_roofline(cfg, batch, seq, kind, mesh, step_layout)
    measured_s = (profile["device_busy_ms"] / 1e3 if profile is not None
                  else step_s)
    coll = 0.0 if dist is None else sum(dist["collective_bytes"].values())
    if dist is not None:
        dist["peak_mem_gb"] = peak_gb
    rec = {
        "arch": cfg.name, "shape": shape, "kind": kind, "layout": layout,
        "step_layout": step_layout,
        "mesh": ("1 card" if world == 1 else
                 ("" if mesh["pod"] == 1 else f"pod {mesh['pod']} x ")
                 + f"data {mesh['data']} x model {mesh['model']} "
                 f"(one host)"),
        "world_size": world, "microbatches": microbatches,
        "device": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "reduced": reduced, "seq": seq, "seq_of": seq_of, "batch": batch,
        "batch_of": batch_of,
        "cut": f"batch {batch} of {batch_of}" + (
            f", seq {seq} of {seq_of}" if seq != seq_of else ", seq uncut"),
        "traced": (f"{device.type}: K1-K4 on their routes; world {world}, "
                   f"{step_layout}" if device.type == "cuda"
                   else f"{device.type}: the kernels' plain versions; "
                        f"world {world}, {step_layout}"),
        "one_card": one_card, "build_s": build_s, "warmup_s": warmup_s,
        "step_s": step_s, "step_measured_by": "host clock, synchronized",
        "peak_mem_gb": peak_gb, "profile": profile, "launches": launches,
        "allreduce_bytes": (0 if grid is None else
                            grid.dist.allreduce_bytes - allreduce_before),
        "allreduce": ("world 1: no collective is issued" if world == 1 else
                      "the measured step's all-reduced bytes (gradients "
                      "under dp; replicated leaves, the loss and the norm "
                      "under fsdp_*); all collectives in dist"),
        "analytic": analytic,
        "profile_terms": dict(profile_terms(
            measured_s, analytic["flops_per_chip"],
            analytic["hbm_bytes_per_chip"], coll),
            measured_by=("device busy time (torch.profiler)"
                         if profile is not None else "host step time")),
        **outcome,
    }
    if kind == "train":
        rec["losses"] = losses
    if dist is not None:
        rec["dist"] = dist
        rec["analytic_collective_bytes"] = collective_bytes_per_chip(
            cfg, batch, seq, kind, mesh_dims(mesh), step_layout)
    print(f"[{cfg.name} x {shape} x {layout}] {rec['cut']} on "
          f"{rec['device_name']}: step {step_s * 1e3:.1f} ms, lower bound "
          f"{analytic['step_time_lower_bound_s'] * 1e3:.1f} ms "
          f"({analytic['dominant']})")
    if save and (grid is None or grid.rank == 0):
        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        with open(save, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def meta_rank_probe(arch: str, shape: str, layout: str = "fsdp_tp", *,
                    microbatches: int = 1, save: Optional[str] = None,
                    reduced: bool = False, batch: Optional[int] = None,
                    seq: Optional[int] = None) -> dict:
    """The reference's two-pod probe: one rank of ``production_dims(
    multi_pod=True)`` traced on ``meta`` at the cell's global ``batch``
    and ``seq`` (by default the shape's), nothing run on any device.
    Returns the per-chip fields (collective bytes by mechanism and in
    all, the bytes held, the peak) and the rank section."""
    seq_of, batch_of, kind = INPUT_SHAPES[shape]
    cfg = effective_config(get_reduced(arch) if reduced else get_config(arch),
                           shape)
    batch, seq = batch or batch_of, seq or seq_of
    mesh = production_dims(multi_pod=True)
    rank = rank_section(cfg, kind, batch, seq, mesh, layout, microbatches)
    rec = {
        "arch": cfg.name, "shape": shape, "kind": kind, "layout": layout,
        "multi_pod": True, "mesh": mesh_tag(True), "measured_on": "meta",
        "ran": "nothing: one rank of the two-pod mesh traced on meta, as "
               "the reference's probe compiles and runs nothing",
        "reduced": reduced, "seq": seq, "batch": batch,
        "collective_bytes_per_chip": rank["collective_bytes"],
        "collective_bytes_total": sum(rank["collective_bytes"].values()),
        "analytic_collective_bytes": rank["analytic_collective_bytes"],
        "bytes": rank["bytes"], "bytes_held": sum(
            rank["bytes"][k] for k in ("params", "grads", "optimizer_state",
                                       "inputs", "decode_state")),
        "peak_bytes": rank["peak_bytes"],
        "fits_one_card": rank["fits_one_card"],
        "rank": rank,
        "analytic": analytic_roofline(cfg, batch, seq, kind, mesh, layout),
    }
    print(f"[{cfg.name} x {shape} x {layout}] rank {rank['rank']} of "
          f"{mesh_tag(True)} on meta: collective "
          f"{rec['collective_bytes_total'] / 1e9:.3f} GB, peak "
          f"{rec['peak_bytes'] / 1e9:.2f} GB")
    if save:
        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        with open(save, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main():
    # thin shim over the repro_torch.api registry (RunSpec in, RunReport out)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--layout", default="fsdp_tp", choices=list(LAYOUTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--pod", type=int, default=1)
    args = ap.parse_args()

    from repro_torch.api import RunSpec, run
    overrides = {"shape": args.shape, "layout": args.layout,
                 "multi_pod": args.multi_pod,
                 "microbatches": args.microbatches,
                 "world_size": args.world_size, "model": args.model,
                 "pod": args.pod}
    if args.save:
        overrides["save"] = args.save
    if args.device:
        overrides["device"] = args.device
    report = run(RunSpec(kind="perfprobe", arch=args.arch,
                         overrides=overrides))
    if not report.ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

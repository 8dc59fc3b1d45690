"""The (arch x shape x mesh) dry run on the ``meta`` device (the port's
counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    python -m repro_torch.launch run dryrun --arch qwen3-moe-30b-a3b \
        --shape train_4k --mesh multi

The reference lowers and compiles each step for one device of a 256- or
512-chip TPU mesh and records XLA's memory and cost analyses.  The port
builds each step on ``meta`` (:mod:`repro_torch.launch.steps`) and runs
it there: every tensor has a shape and a dtype and no data, so nothing
is allocated on any device.  The kernels take their meta route
(``kernels/*/meta.py``): their output shapes, and their own operations
counted.  Each record keeps the reference's keys where they mean the same
thing (``arch``, ``shape``, ``kind``, ``mesh``, ``layout``, ``seq``,
``batch``, ``status``, ``roofline``, ``total_s``) and adds two traces.

**One card**, world 1 under ``dp`` at the shape's global batch, made once
per (arch, shape) and shared by both meshes' records:

* ``traced_flops``: ``FlopCounterMode``'s count of the step, by operator
  too, and its ratio to the analytic count for one chip (a train step's
  forward and backward as the trainer runs them, remat included; its
  optimizer update is elementwise, counts no FLOPs and saves nothing, and
  is left out of the trace but for its temporaries);
* ``bytes``: parameters, gradients, optimizer state (``pick_optimizer``'s
  dtype), inputs, decode state, and the activations autograd saves for the
  backward (summed over distinct storages with ``saved_tensors_hooks``,
  under remat as the trainer runs it);
* ``peak_bytes``: the most bytes of storage alive at once in the step
  (:class:`LivePeak`): the kinds above at their highest point plus the
  transient working set (a layer's recompute in the backward, the chunked
  loss's logits, a prefill layer's f32 intermediates, the optimizer's
  temporaries, K4's backward as the card runs it: ``CARD_WORKSPACE``),
  what ``torch.cuda.max_memory_allocated`` reads on the card;
* ``fits_one_card``: whether that peak fits 80 GB less
  :class:`repro_torch.core.autobatch.MemoryBudget`'s reserve;
* ``max_batch_one_card`` and ``peak_bytes_one_card``: the largest batch,
  halving from the shape's batch over the reference's data axis (16),
  whose peak fits (:func:`peak_at`).

**One rank of the production mesh** (``rank``, :func:`rank_section`):
the grid's last rank of ``production_dims(multi_pod)`` (16x16 or
2x16x16; under ``dp`` its pod and data axes), its step built through
``steps.build`` over a :func:`repro_torch.distributed.context.
meta_context` under the record's layout: its blocks of the parameters
and moments, its rows of the batch over ``(pod, data)``, its own loss
with its gathers, reductions and model-axis collectives, counted and
not run.  The section holds ``grid``, ``rank``, ``coords``, ``rows``,
``traced_flops`` (and by operator) against ``analytic_flops_per_chip``,
``bytes`` by kind, ``peak_bytes`` and ``fits_one_card`` (the same
budget), ``collective_bytes``, ``collective_calls`` and the group sizes
by mechanism against ``analytic_collective_bytes``
(``collective_bytes_per_chip`` on the mesh), the port's counts from the
shapes (``tp_allreduce``, the whole attention's ``tp_weights``,
``sp_bytes``, ``pod_gradsync``), and ``resident_minus_sharded``: its
parameters, gradients, optimizer state and decode state less
``sharded_bytes``, 0 where it holds the rules' blocks.

``sharded_bytes`` is what one device of the mesh holds by the rules'
specs (:func:`repro_torch.sharding.rules.per_device_bytes`): the
counterpart of the reference's ``memory_analysis`` argument sizes.
``roofline`` is :func:`repro_torch.analysis.analytic.analytic_roofline`
on the mesh for ``layout``, with the H100's figures.  A cell that cannot
be traced is recorded as ``status: "error"`` with the port's message, as
the reference records a failed lowering; it is never traced at another
layout or another mesh under its name.  The probe
(:mod:`repro_torch.launch.perfprobe`) runs a cell at its one-card batch
and measures the peak on the card.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import os
import time
import traceback
import weakref
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.analytic import (MeshDims, analytic_roofline,
                                           collective_bytes_per_chip,
                                           flops_per_chip, mesh_dims)
from repro_torch.configs import get_config, list_archs
from repro_torch.core.autobatch import MemoryBudget
from repro_torch.distributed.context import meta_context
from repro_torch.kernels.ssd_scan.ops import plain_backward
from repro_torch.launch.mesh import INPUT_SHAPES, mesh_tag, production_dims
from repro_torch.launch.steps import build, effective_config, pick_optimizer
from repro_torch.models.model import init_decode_state, param_specs
from repro_torch.sharding import rules
from repro_torch.sharding.grid import RankGrid
from repro_torch.sharding.sp import sp_bytes
from repro_torch.sharding.tp import tp_allreduce_bytes, tp_weights_bytes
from repro_torch.train.step import _global_sq_norm
from repro_torch.tree import tree_leaves

# (arch, shape) pairs that are structurally skipped (encoder-only has no
# autoregressive decode) — recorded, not silently dropped.
STRUCTURAL_SKIPS = {
    ("hubert-xlarge", "decode_32k"): "encoder-only: no decode step",
    ("hubert-xlarge", "long_500k"): "encoder-only: no decode step",
}

CARD_BYTES = 80e9                 # one H100 80GB
DATA_AXIS = production_dims()["data"]
TRACED = "meta: kernel formulas; world 1, dp"
ONE_CHIP = MeshDims(pod=1, data=1, model=1)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def one_card_budget() -> float:
    """Bytes a step may hold on one card: 80 GB less the reserve."""
    budget = MemoryBudget(device_gb=CARD_BYTES / 1e9)
    return budget.device_gb * 1e9 * (1 - budget.reserve_frac)


def _specs(args) -> tuple:
    """Arguments with each tensor as its (shape, dtype): nothing held."""
    return tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                 else a for a in args)


@functools.lru_cache(maxsize=None)
def ssd_backward_workspace(specs: tuple) -> int:
    """The bytes K4's backward holds beyond its inputs on the card, where
    it is autograd of the plain chunked scan (``ssd_scan.ops.
    plain_backward``): the recompute's saved tensors and the gradients.
    The meta route's backward allocates only the gradients, so the card's
    own code is traced on meta at ``specs`` (the operator's arguments)."""
    *tensors, chunk = specs
    args = [torch.empty(shape, dtype=dtype, device="meta")
            for shape, dtype in tensors]
    live = LivePeak()
    for t in args:
        live.track(t)
    held = live.now
    with live:
        plain_backward(*args, chunk)
    return live.peak - held


# what an operator of the meta route holds on the card beyond its inputs
# and outputs, where that is more than nothing
CARD_WORKSPACE = {
    torch.ops.repro_torch.ssd_scan_bwd.default: ssd_backward_workspace}


class LivePeak(TorchDispatchMode):
    """The most bytes of storage alive at once while the mode is on, as
    the card's allocator would hold them (less its block rounding).  A
    storage counts from the first operator that returns it, or from
    :meth:`track`, until it is freed: a finalizer on the storage object,
    which lives as long as the storage does.  Views and in-place results
    share their base's storage and add nothing.  Each storage gets a
    serial number that no later storage reuses.  A call of an operator in
    ``watch`` is noted with its arguments' shapes and the bytes alive when
    it starts (``calls``)."""

    def __init__(self, watch=()):
        super().__init__()
        self.live: Dict[int, Tuple[int, int]] = {}   # key -> serial, bytes
        self.now = self.peak = 0
        self._serials = itertools.count()
        self.watch = set(watch)
        self.calls: List[Tuple[object, tuple, int]] = []

    def track(self, t: torch.Tensor) -> int:
        storage = t.untyped_storage()
        key = storage._cdata
        hit = self.live.get(key)
        if hit is None:
            hit = self.live[key] = (next(self._serials), storage.nbytes())
            self.now += hit[1]
            self.peak = max(self.peak, self.now)
            weakref.finalize(storage, self._free, key)
        return hit[0]

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.watch:
            self.calls.append((func, _specs(args), self.now))
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


def trace_step(kind: str, cfg, batch: int, seq: int,
               microbatches: int = 1, layout: str = "dp",
               grid=None) -> Dict:
    """Build the step on ``meta`` and run it once under ``FlopCounterMode``,
    a saved-tensor hook and :class:`LivePeak`.  Returns the traced FLOPs
    (in all and by operator), the bytes by kind and the peak of live
    bytes (``peak_bytes``: what the step holds at its highest point, the
    transient working set included, and what an operator of the meta
    route holds on the card beyond its inputs, ``CARD_WORKSPACE``).

    ``grid`` (over a :func:`repro_torch.distributed.context.
    meta_context`): one rank of it under ``layout``, its own step with
    its gathers and reductions (a train step's gradient norm included),
    its blocks and rows; the result adds the rank's collective bytes
    and calls by mechanism and the group sizes each ran over, and
    ``fsdp`` (the step's storage, or None)."""
    kw = {"microbatches": microbatches} if kind == "train" else {}
    fn, args = build(kind, cfg, batch, seq, device="meta", layout=layout,
                     grid=grid, **kw)
    fsdp = None
    if kind == "train":
        # the trainer's forward and backward; the update after them counts
        # no FLOPs, saves nothing and adds to the peak only one leaf's
        # temporaries at a time (update_transient)
        state, inputs = args
        params, opt = state.params, state.opt_state
        step, fsdp = fn, fn.fsdp

        def fn(params, inputs):
            loss, grads = step.loss_and_grads(params, inputs)
            if grid is not None:
                step.sq_norm(grads)
            return loss, grads

        args = (params, inputs)
    elif kind == "prefill":
        (params, inputs), opt = args, None
    else:
        params, state, tokens, position = args
        inputs, opt = {"tokens": tokens, "position": position}, None
    param_leaves = tree_leaves(params)
    live = LivePeak(watch=CARD_WORKSPACE)
    held = param_leaves + list(inputs.values()) + (
        tree_leaves(opt) if opt is not None else []) + (
        tree_leaves(state) if kind == "decode" else [])
    known = {live.track(t) for t in held}
    saved: Dict[int, int] = {}

    def pack(t):
        key = live.track(t)
        if key not in known:
            saved[key] = t.untyped_storage().nbytes()
        return t

    with FlopCounterMode(display=False) as counter, live, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*args)
    by_op = {str(op): int(n)
             for op, n in counter.get_flop_counts()["Global"].items()}
    decode_state = 0
    if kind == "decode":
        decode_state = _nbytes(tree_leaves(state))
    elif kind == "prefill" and isinstance(out, tuple):
        decode_state = _nbytes(tree_leaves(out[1]))
    p_bytes = _nbytes(param_leaves)
    nbytes = {"params": p_bytes,
              "grads": p_bytes if kind == "train" else 0,
              "optimizer_state": (_nbytes(tree_leaves(opt))
                                  if opt is not None else 0),
              "inputs": _nbytes(inputs.values()),
              "decode_state": decode_state,
              "saved_activations": sum(saved.values())}
    peak = max([live.peak] + [now + CARD_WORKSPACE[func](specs)
                              for func, specs, now in live.calls])
    if kind == "train":
        # what the step holds once the gradients are out, plus the update
        peak = max(peak, live.now + update_transient(cfg, param_leaves,
                                                     out[1]))
    traced = {"traced_flops": int(counter.get_total_flops()),
              "traced_flops_by_op": by_op, "bytes": nbytes,
              "peak_bytes": peak}
    if grid is not None:
        dist = grid.dist
        traced.update(
            collective_bytes=dict(dist.collective_bytes),
            collective_calls=dict(dist.collective_calls),
            collective_group_sizes={
                mech: sorted({len(r) for r in groups})
                for mech, groups in dist.collective_groups.items()},
            fsdp=fsdp, params=params, rows=next(iter(inputs.values())))
    return traced


def update_transient(cfg, param_leaves: list, grads: list) -> int:
    """The bytes that the gradient norm and the optimizer update hold
    beyond the step's tensors.  Both run leaf by leaf, so this is the
    largest leaf's temporaries, traced on that leaf alone: tracing the
    update of every leaf on ``meta`` would cost as much as the rest of the
    step and find the same peak."""
    i = max(range(len(param_leaves)), key=lambda j: param_leaves[j].numel())
    p, g = {"w": param_leaves[i]}, {"w": grads[i]}
    optimizer = pick_optimizer(cfg)
    opt = optimizer.init(p)
    live = LivePeak()
    for t in tree_leaves(p) + tree_leaves(g) + tree_leaves(opt):
        live.track(t)
    held = live.now
    with live:
        _global_sq_norm(g)
        optimizer.update(g, opt, p, 0, 1e-4)
    return live.peak - held


def peak_at(traced: Dict, batch: int, rows: int) -> float:
    """The peak at ``rows`` from the one traced at ``batch``: parameters,
    gradients and optimizer state stay, everything else scales with the
    rows.  Every gradient is alive at once at the end of the backward, so
    taking them all as fixed over-reads any point of the step where some
    are not (by their share of ``1 - rows / batch``)."""
    nb = traced["bytes"]
    fixed = nb["params"] + nb["grads"] + nb["optimizer_state"]
    return fixed + (traced["peak_bytes"] - fixed) * rows / batch


def one_card_fit(traced: Dict, batch: int):
    """``(fits at batch, largest batch that fits)`` from the peak traced
    at ``batch``: halving from ``batch // DATA_AXIS`` (at least 1); 0 if
    none fits."""
    budget = one_card_budget()
    b = max(batch // DATA_AXIS, 1)
    while b and peak_at(traced, batch, b) > budget:
        b //= 2
    return traced["peak_bytes"] <= budget, b


def sharded_bytes(cfg, kind: str, batch: int, seq: int, mesh,
                  layout: str) -> Dict:
    """Bytes one device of ``mesh`` (an axis-size dict) holds under
    ``layout``, by kind, from the rules' specs of the meta trees."""
    params = param_specs(cfg)
    p_bytes = rules.per_device_bytes(
        params, rules.param_shardings(params, mesh, layout), mesh)
    out = {"params": p_bytes, "grads": 0, "optimizer_state": 0,
           "decode_state": 0}
    if kind == "train":
        opt = pick_optimizer(cfg).init(params)
        out["grads"] = p_bytes
        out["optimizer_state"] = rules.per_device_bytes(
            opt, rules.param_shardings(opt, mesh, layout), mesh)
    elif not cfg.is_encoder_only:
        # decode: the cache it reads; prefill: the cache it fills
        state = init_decode_state(cfg, batch, seq, device="meta")
        out["decode_state"] = rules.per_device_bytes(
            state, rules.decode_state_shardings(state, mesh, layout), mesh)
    return out


RESIDENT = ("params", "grads", "optimizer_state", "decode_state")


def rank_grid(mesh, layout: str) -> RankGrid:
    """One rank of ``mesh`` (an axis dict) under ``layout`` on ``meta``:
    the grid's last rank, every coordinate at its last index (under
    ``fsdp_sp`` its sequence block holds the most causal pairs).  Under
    ``dp`` the grid is the mesh's pod and data axes: the port's ``dp``
    refuses a model axis, and the reference's model ranks repeat the
    same step."""
    dims = {a: n for a, n in mesh.items()
            if not (layout == "dp" and a == "model")}
    world = math.prod(dims.values())
    return RankGrid(dims, meta_context(world, world - 1))


def rank_section(cfg, kind: str, batch: int, seq: int, mesh, layout: str,
                 microbatches: int = 1) -> Dict:
    """One rank of ``mesh`` traced on ``meta`` (:func:`rank_grid`): its
    FLOPs against ``flops_per_chip`` on the rank's grid, its bytes by
    kind, its peak and whether it fits one card, its collective bytes
    and calls by mechanism against ``collective_bytes_per_chip`` on
    ``mesh``, the port's counts from the shapes, and its resident bytes
    against :func:`sharded_bytes` (``resident_minus_sharded``, by kind;
    0 where the rank holds the rules' blocks)."""
    grid = rank_grid(mesh, layout)
    t = trace_step(kind, cfg, batch, seq, microbatches, layout, grid)
    analytic = flops_per_chip(cfg, batch, seq, kind, mesh_dims(grid.mesh))
    rows = t["rows"].shape[0]
    M = grid.extent("model")
    esize = getattr(torch, cfg.param_dtype).itemsize
    shape_counts = {}
    if layout == "fsdp_tp" and M > 1:
        shape_counts["tp_allreduce"] = tp_allreduce_bytes(
            cfg, rows, seq, kind, M, esize)
        shape_counts["tp_weights_whole_attention"] = tp_weights_bytes(
            cfg, kind, M, esize)
    if layout == "fsdp_sp" and M > 1:
        shape_counts["sp_bytes"] = sp_bytes(cfg, rows, seq, kind, M, esize)
    if t["fsdp"] is not None:
        shape_counts["pod_gradsync"] = t["fsdp"].pod_gradsync_bytes(
            t["params"])
    sharded = sharded_bytes(cfg, kind, batch, seq, mesh, layout)
    out = {
        "grid": grid.mesh, "rank": grid.rank, "coords": grid.coords,
        "rows": rows, "layout": layout,
        "traced": f"meta: kernel formulas; rank {grid.rank} of "
                  f"{grid.world_size}, {layout}",
        "traced_flops": t["traced_flops"],
        "traced_flops_by_op": t["traced_flops_by_op"],
        "analytic_flops_per_chip": analytic,
        "traced_over_analytic": t["traced_flops"] / analytic,
        "bytes": t["bytes"], "peak_bytes": t["peak_bytes"],
        "fits_one_card": t["peak_bytes"] <= one_card_budget(),
        "collective_bytes": t["collective_bytes"],
        "collective_calls": t["collective_calls"],
        "collective_group_sizes": t["collective_group_sizes"],
        "analytic_collective_bytes": collective_bytes_per_chip(
            cfg, batch, seq, kind, mesh_dims(mesh), layout),
        "shape_counts": shape_counts,
        "resident_minus_sharded": {k: t["bytes"][k] - sharded[k]
                                   for k in RESIDENT}}
    if layout == "dp" and "model" in mesh:
        out["note"] = (f"dp: the rank sits on the pod and data axes of "
                       f"{mesh}; the reference's {mesh['model']} model "
                       f"ranks repeat the same step")
    return out


def _write(rec: dict, out_dir: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}_{rec['layout']}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)


def run_one(arch: str, shape_name: str, multi_pod: bool, layout: str,
            out_dir: str, microbatches: int = 1,
            one_card: Optional[Dict] = None) -> dict:
    """One (arch x shape x mesh) record: the one-card trace (world 1,
    ``dp``; taken from ``one_card``, a dict shared by the meshes of one
    (arch, shape), where an earlier record made it) and the ``rank``
    section of the mesh under ``layout``."""
    seq, batch, kind = INPUT_SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": mesh_tag(multi_pod), "layout": layout, "seq": seq,
        "batch": batch,
    }
    if (arch, shape_name) in STRUCTURAL_SKIPS:
        rec["status"] = "skipped"
        rec["reason"] = STRUCTURAL_SKIPS[(arch, shape_name)]
        _write(rec, out_dir)
        return rec

    t0 = time.time()
    one_card = {} if one_card is None else one_card
    try:
        cfg = effective_config(get_config(arch), shape_name)
        mesh = production_dims(multi_pod)
        rec["roofline"] = analytic_roofline(cfg, batch, seq, kind, mesh,
                                            layout)
        rec["sharded_bytes"] = dict(
            sharded_bytes(cfg, kind, batch, seq, mesh, layout),
            mesh=mesh_tag(multi_pod), layout=layout)
        if "traced" not in one_card:
            one_card["traced"] = trace_step(kind, cfg, batch, seq,
                                            microbatches)
        traced = one_card["traced"]
        analytic = flops_per_chip(cfg, batch, seq, kind, ONE_CHIP)
        fits, max_batch = one_card_fit(traced, batch)
        rec.update(
            traced=TRACED, one_card={"world_size": 1, "layout": "dp",
                                     "batch": batch, "seq": seq},
            traced_flops=traced["traced_flops"],
            traced_flops_by_op=traced["traced_flops_by_op"],
            analytic_flops_one_chip=analytic,
            traced_over_analytic=traced["traced_flops"] / analytic,
            bytes=traced["bytes"],
            bytes_total=sum(traced["bytes"].values()),
            peak_bytes=traced["peak_bytes"],
            peak_bytes_one_card=(peak_at(traced, batch, max_batch)
                                 if max_batch else None),
            one_card_budget_bytes=one_card_budget(),
            fits_one_card=fits, max_batch_one_card=max_batch)
        t1 = time.time()
        rec["rank"] = rank_section(cfg, kind, batch, seq, mesh, layout,
                                   microbatches)
        rec["rank"]["trace_s"] = round(time.time() - t1, 2)
        rec["trace_s"] = round(time.time() - t0, 2)
        rec["status"] = "ok"
        r = rec["roofline"]
        print(f"  analytic: compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms "
              f"collective={r['collective_s']*1e3:.2f}ms "
              f"dominant={r['dominant']} "
              f"mfu_ub={r['mfu_upper_bound']:.2f}")
        gb = {k: round(v / 1e9, 2) for k, v in rec["bytes"].items()}
        print(f"  one card: traced/analytic="
              f"{rec['traced_over_analytic']:.4f} bytes={gb} GB "
              f"peak={rec['peak_bytes'] / 1e9:.2f} GB fits={fits} "
              f"max_batch={max_batch}")
        rk = rec["rank"]
        print(f"  rank {rk['rank']} of {rk['grid']}: traced/analytic="
              f"{rk['traced_over_analytic']:.4f} "
              f"peak={rk['peak_bytes'] / 1e9:.2f} GB "
              f"fits={rk['fits_one_card']} collective="
              f"{sum(rk['collective_bytes'].values()) / 1e9:.3f} GB "
              f"resident-sharded={rk['resident_minus_sharded']}")
    except Exception as e:  # noqa: BLE001 — a dry-run failure is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"  ERROR {type(e).__name__}: {str(e)[:400]}")
    rec["total_s"] = round(time.time() - t0, 1)
    _write(rec, out_dir)
    return rec


def dryrun_sweep(archs="all", shapes="all", meshes="single",
                 layout="fsdp_tp", microbatches: int = 1,
                 out: str = "experiments/dryrun_torch") -> list:
    """The full (arch x shape x mesh) sweep; the body behind both the
    ``repro_torch.api`` dryrun runner and this module's CLI shim."""
    arch_list = list_archs() if archs == "all" else archs.split(",")
    shape_list = list(INPUT_SHAPES) if shapes == "all" else [shapes]
    mesh_list = {"single": [False], "multi": [True],
                 "both": [False, True]}[meshes]

    results = []
    for arch in arch_list:
        for shape in shape_list:
            one_card: Dict = {}        # the meshes share its trace
            for mp in mesh_list:
                print(f"[dryrun] {arch} x {shape} x {mesh_tag(mp)} x "
                      f"{layout}", flush=True)
                rec = run_one(arch, shape, mp, layout, out, microbatches,
                              one_card)
                results.append(rec)
                print(f"  -> {rec['status']} ({rec.get('total_s', 0)}s)",
                      flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"\n[dryrun] ok={n_ok} skipped={n_skip} error={n_err}")
    for r in results:
        if r["status"] == "error":
            print(f"  FAILED: {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['error'][:200]}")
    return results


def main():
    # thin shim over the repro_torch.api registry (RunSpec in, RunReport out)
    ap = argparse.ArgumentParser(
        description="the dry run on meta: one card, and one rank of the mesh")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    choices=["all", *INPUT_SHAPES])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--layout", default="fsdp_tp",
                    choices=["fsdp_tp", "fsdp_sp", "dp"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args()

    from repro_torch.api import RunSpec, run
    report = run(RunSpec(kind="dryrun", arch=args.arch, overrides={
        "shape": args.shape, "mesh": args.mesh, "layout": args.layout,
        "microbatches": args.microbatches, "out": args.out}))
    if not report.ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

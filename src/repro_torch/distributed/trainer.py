"""The data-parallel trainer: ``train_main``'s multi-process twin.

One ``dist_train_main`` call is ONE rank of a gang.  Rank 0 hosts the
process group's store and owns checkpoint *writes*; every rank restores
from the same checkpoint directory on resume (writes are atomic ``tmp ->
rename`` publishes, so readers never see torn state) and the loop
checks that every rank restored the same step before any collective
runs.  Every rank draws the same parameters from the seed (checked by a
checksum, and again after the last step) and the identical global batch
stream, keeps its rows, and sums its gradients with the others' (see
:func:`repro_torch.train.make_train_step`), so the losses at world N are
the single process's at the same global batch up to the order of the
f32 sums.  At world 1 there is no process group and the run is
``train_main``'s, bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.train.loop import TrainLoop


class DistributedTrainLoop(TrainLoop):
    """A :class:`repro_torch.train.TrainLoop` whose resume checks that
    every rank restored the same step."""

    def __init__(self, step_fn, state, data, *, ctx, **kw):
        super().__init__(step_fn, state, data, **kw)
        self.ctx = ctx

    def resume(self) -> bool:
        restored = super().resume()
        self.ctx.agree(self.start_step, "resumed step")
        return restored


def allreduce_bytes_per_step(param_bytes: int, world: int) -> int:
    """Analytic ring all-reduce traffic per step and per rank:
    ``2 * (N-1)/N * grad_bytes`` (reduce-scatter + all-gather), the
    FireCaffe reduction-bandwidth model.  Zero at world=1."""
    if world <= 1:
        return 0
    return int(2 * (world - 1) / world * param_bytes)


def _route_counts() -> Dict[str, Dict[str, int]]:
    """The attention and SSD-scan kernels' launch counters, by route."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    fns = {"flash_attention_fwd": fa.flash_attention_fwd_kernel,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_kernel,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_kernel,
           "ssd_scan": ssd.ssd_scan_kernel}
    return {name: dict(fn.launches_by_route) for name, fn in fns.items()}


def dist_train_main(arch: str, *, world_size: int, dist_rank: int = 0,
                    coordinator: Optional[str] = None, device=None,
                    batch: int = 8, microbatches: int = 1,
                    **kw) -> Dict[str, Any]:
    """Run one rank of a data-parallel training job.  ``batch`` is the
    GLOBAL batch; each rank computes ``batch / world_size`` rows.  The
    other keywords are :func:`repro_torch.launch.train.run_rank`'s.
    The return dict is ``train_main``'s result plus a ``dist`` section
    (rank 0's report is the one the executor and the gang launcher
    parse): the reference's keys, then the backend, the device and what
    this rank measured (all-reduce seconds and bytes, ``agree`` calls,
    kernel launches by route, peak memory on a card)."""
    from repro_torch.distributed.context import init_distributed
    from repro_torch.launch.train import run_rank
    from repro_torch.tree import tree_leaves

    if batch % max(1, int(world_size)):
        raise ValueError(f"global batch {batch} must divide over "
                         f"{world_size} ranks")
    ctx = init_distributed(world_size, dist_rank, coordinator, device)
    try:
        before = _route_counts()
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        result, loop = run_rank(arch, ctx, batch=batch,
                                microbatches=microbatches, **kw)
        after = _route_counts()
        # the reference's count: every parameter as 4 bytes
        param_bytes = sum(p.numel() * 4
                          for p in tree_leaves(loop.state.params))
        steps_run = max(1, result["steps_run"])
        result["dist"] = {
            "world_size": ctx.world_size,
            "rank": ctx.rank,
            "devices": ctx.world_size,
            "global_batch": batch,
            "local_batch": batch // ctx.world_size,
            "microbatches": max(1, int(microbatches)),
            "grad_bytes": param_bytes,
            # per-rank ring traffic for the one gradient reduction a step
            "allreduce_bytes_per_step": allreduce_bytes_per_step(
                param_bytes, ctx.world_size),
            "backend": ctx.backend,
            "device": str(ctx.device),
            # measured: the buckets' bytes (the gradients and the loss)
            # and seconds, over the steps this rank ran
            "reduced_bytes_per_step": ctx.allreduce_bytes / steps_run,
            "allreduce_s_per_step": ctx.allreduce_s / steps_run,
            "allreduce_calls": ctx.allreduce_calls,
            # the small gathers: each step's counts, and agree
            "allgather_s": ctx.allgather_s,
            "step_s": loop.step_times,
            "agree_calls": ctx.agree_calls,
            "kernel_launches": {
                name: {r: after[name][r] - before[name][r]
                       for r in after[name]} for name in after},
        }
        if ctx.device.type == "cuda":
            result["dist"]["peak_mem_gb"] = (
                torch.cuda.max_memory_allocated(ctx.device) / 1e9)
    finally:
        ctx.close()
    return result

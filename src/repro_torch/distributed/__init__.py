"""Multi-process data-parallel training (the port of ``repro.distributed``).

The campaign executor scales *across* runs; this package scales a
*single* run across processes: ``torch.distributed`` ranks each hold a
contiguous row shard of the global batch, compute local gradients
through the train step, and sum them with one all-reduce over flat
buckets before the gradient norm, the clip and the update.  Each rank's
loss divides by the count of scored positions summed over the ranks, so
the sum of the ranks' gradients is the single process's gradient of the
global batch.

Exports resolve lazily: the executor imports :mod:`.gang` helpers from
its torch-free scheduler process, so importing this package (or
:mod:`.gang`) must not load torch (only :mod:`.context`, :mod:`.data`
and :mod:`.trainer` do).
"""
from __future__ import annotations

_EXPORTS = {
    "DistContext": "repro_torch.distributed.context",
    "init_distributed": "repro_torch.distributed.context",
    "ShardedBatches": "repro_torch.distributed.data",
    "shard_rows": "repro_torch.distributed.data",
    "DistributedTrainLoop": "repro_torch.distributed.trainer",
    "dist_train_main": "repro_torch.distributed.trainer",
    "allreduce_bytes_per_step": "repro_torch.distributed.trainer",
    "free_port": "repro_torch.distributed.gang",
    "rank_argv": "repro_torch.distributed.gang",
    "run_gang_local": "repro_torch.distributed.gang",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)

"""Rank-sharded views over the seekable batch streams.

Every rank advances an *identical* global stream (same seed, same rng
trajectory, same cursor), so the union of the ranks' shards is exactly
the batch a single process at the same global batch size would draw.
Cursors are therefore global and rank-agnostic: any rank's cursor
resumes every rank.
"""
from __future__ import annotations

from typing import Any, Dict


def shard_rows(batch: Dict[str, Any], rank: int, world: int
               ) -> Dict[str, Any]:
    """Rank's contiguous row shard of a global batch dict (numpy arrays
    or tensors)."""
    out = {}
    for key, arr in batch.items():
        if arr.shape[0] % world:
            raise ValueError(f"batch dim {arr.shape[0]} of {key!r} not "
                             f"divisible by world size {world}")
        per = arr.shape[0] // world
        out[key] = arr[rank * per:(rank + 1) * per]
    return out


class ShardedBatches:
    """Wrap a seekable *global* stream for one rank.

    ``inner`` yields full global batches as dicts of host tensors
    (``next_batch/cursor/seek``: the port's ``LMDictBatches`` and
    ``SeekableSyntheticBatches`` on the CPU).  Each ``next_batch``
    advances the global stream, keeps this rank's rows and copies them
    to the rank's device.
    """

    def __init__(self, inner: Any, ctx):
        self.inner = inner
        self.ctx = ctx

    def next_batch(self):
        rows = shard_rows(self.inner.next_batch(), self.ctx.rank,
                          self.ctx.world_size)
        return {k: v.to(self.ctx.device) for k, v in rows.items()}

    def cursor(self) -> dict:
        return self.inner.cursor()

    def seek(self, cursor: dict) -> None:
        self.inner.seek(cursor)

    def __iter__(self):
        while True:
            yield self.next_batch()

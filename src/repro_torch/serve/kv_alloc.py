"""Paged KV-cache allocator: block tables over a shared token-block pool.
The port's own copy of ``repro.serve.kv_alloc``.

The physical decode caches stay fixed-shape per slot (``cache_len`` rows,
updated in place by the engine's decode step), but *logical* cache
capacity is accounted here in fixed-size token blocks drawn from one
shared pool.  That decouples ``cache_len`` (the per-request ceiling) from
the aggregate KV budget: a scheduler can run ``slots`` concurrent requests
against a pool smaller than ``slots * cache_len`` because typical requests
never grow to the ceiling.  Each request owns a block table (list of block
ids); blocks are appended as the sequence grows, recycled on completion,
and reclaimed by evicting a victim request when the pool is exhausted.

Eviction policy (``lru_victim``): least-recently-*scheduled* request
first (stale entries lose their blocks before hot ones); among equally
recent requests the lowest ``priority`` loses first, and ties break
toward the most recently admitted — evicting the newest request
preserves the most accumulated decode work, mirroring vLLM's recompute
preemption.  The allocator only does accounting and victim selection;
requeue/re-prefill of the evicted request is the scheduler's job.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class BlockTable:
    """Per-request view of the pool: which blocks hold its tokens."""
    rid: int
    blocks: List[int]
    n_tokens: int = 0            # logical sequence length accounted for
    priority: int = 0            # JobSpec.priority semantics: higher first
    last_used: int = 0           # scheduler tick of the last grow/touch
    admit_seq: int = 0           # monotone admission counter


class PagedKVAllocator:
    """Fixed pool of ``total_blocks`` blocks of ``block_size`` tokens."""

    def __init__(self, total_blocks: int, block_size: int = 16):
        if total_blocks <= 0 or block_size <= 0:
            raise ValueError("total_blocks and block_size must be positive, "
                             f"got {total_blocks} x {block_size}")
        self.total_blocks = total_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(total_blocks - 1, -1, -1))
        self._tables: Dict[int, BlockTable] = {}
        self._admit_seq = 0
        self.stats = {"allocated_blocks": 0, "freed_blocks": 0,
                      "peak_blocks_in_use": 0, "failed_grows": 0}

    # ------------------------------------------------------------ sizing
    def blocks_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.total_blocks - len(self._free)

    def table(self, rid: int) -> Optional[BlockTable]:
        return self._tables.get(rid)

    def holders(self) -> List[int]:
        return list(self._tables)

    def can_admit(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= len(self._free)

    # -------------------------------------------------------- lifecycle
    def admit(self, rid: int, n_tokens: int, *, priority: int = 0,
              tick: int = 0) -> bool:
        """Reserve blocks for a request entering a slot with ``n_tokens``
        already in (or about to enter) its cache.  False if the pool
        cannot cover it (caller evicts and retries, or keeps it queued)."""
        if rid in self._tables:
            raise ValueError(f"rid {rid} already holds a block table")
        need = self.blocks_for(n_tokens)
        if need > len(self._free):
            self.stats["failed_grows"] += 1
            return False
        blocks = [self._free.pop() for _ in range(need)]
        self._admit_seq += 1
        self._tables[rid] = BlockTable(
            rid=rid, blocks=blocks, n_tokens=n_tokens, priority=priority,
            last_used=tick, admit_seq=self._admit_seq)
        self.stats["allocated_blocks"] += need
        self._note_peak()
        return True

    def grow(self, rid: int, n_tokens: int, *, tick: int = 0) -> bool:
        """Extend ``rid`` to cover ``n_tokens`` total; allocates new
        blocks as the sequence crosses block boundaries.  False (with no
        partial allocation) if the pool is exhausted."""
        t = self._tables[rid]
        t.last_used = tick
        need = self.blocks_for(n_tokens) - len(t.blocks)
        if need <= 0:
            t.n_tokens = max(t.n_tokens, n_tokens)
            return True
        if need > len(self._free):
            self.stats["failed_grows"] += 1
            return False
        t.blocks.extend(self._free.pop() for _ in range(need))
        t.n_tokens = n_tokens
        self.stats["allocated_blocks"] += need
        self._note_peak()
        return True

    def release(self, rid: int) -> int:
        """Recycle every block ``rid`` holds (completion or eviction).
        Returns the number of blocks returned to the pool."""
        t = self._tables.pop(rid)
        self._free.extend(reversed(t.blocks))
        self.stats["freed_blocks"] += len(t.blocks)
        return len(t.blocks)

    # --------------------------------------------------------- eviction
    def lru_victim(self, exclude: Set[int] = frozenset()) -> Optional[int]:
        """The request to evict when the pool is exhausted: least
        recently used, then lowest priority, then newest admission."""
        candidates = [t for rid, t in self._tables.items()
                      if rid not in exclude]
        if not candidates:
            return None
        victim = min(candidates,
                     key=lambda t: (t.last_used, t.priority, -t.admit_seq))
        return victim.rid

    def _note_peak(self):
        self.stats["peak_blocks_in_use"] = max(
            self.stats["peak_blocks_in_use"], self.used_blocks)

    def snapshot(self) -> Dict[str, object]:
        """Accounting view for stats()/bench reports."""
        return {
            "total_blocks": self.total_blocks,
            "block_size": self.block_size,
            "used_blocks": self.used_blocks,
            "free_blocks": self.free_blocks,
            "peak_blocks_in_use": self.stats["peak_blocks_in_use"],
            "failed_grows": self.stats["failed_grows"],
        }

"""The port's paged KV allocator against the reference's: random sequences
of admit / grow / release / lru_victim (from a numpy seed) give the same
returns, block ids, victims, stats and snapshots in both; and the
reference's own allocator cases, run against the port's copy.  Pure host
logic — no model, no device."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve.kv_alloc import PagedKVAllocator as JPagedKVAllocator  # noqa: E402
from repro_torch.serve import PagedKVAllocator  # noqa: E402


def _state(kv):
    tables = {rid: (list(t.blocks), t.n_tokens, t.priority, t.last_used,
                    t.admit_seq)
              for rid, t in ((r, kv.table(r)) for r in kv.holders())}
    return (tables, kv.free_blocks, kv.used_blocks, dict(kv.stats),
            kv.snapshot())


@pytest.mark.parametrize("seed", range(6))
def test_random_operation_sequences_match_reference(seed):
    rng = np.random.default_rng(seed)
    total, bs = int(rng.integers(4, 40)), int(rng.choice([1, 4, 8, 16]))
    port, ref = PagedKVAllocator(total, bs), JPagedKVAllocator(total, bs)
    next_rid, tick, victims = 0, 0, 0
    for _ in range(400):
        tick += int(rng.integers(0, 2))
        op = rng.choice(["admit", "grow", "release", "victim"],
                        p=[0.35, 0.35, 0.15, 0.15])
        holders = port.holders()
        assert holders == ref.holders()
        if op == "admit":
            n = int(rng.integers(0, 5 * bs))
            prio = int(rng.integers(-1, 2))
            got = [kv.admit(next_rid, n, priority=prio, tick=tick)
                   for kv in (port, ref)]
            next_rid += 1
        elif op == "grow" and holders:
            rid = holders[int(rng.integers(len(holders)))]
            n = port.table(rid).n_tokens + int(rng.integers(0, 3 * bs))
            got = [kv.grow(rid, n, tick=tick) for kv in (port, ref)]
        elif op == "release" and holders:
            rid = holders[int(rng.integers(len(holders)))]
            got = [kv.release(rid) for kv in (port, ref)]
        elif op == "victim":
            k = int(rng.integers(0, len(holders) + 1))
            exclude = set(rng.permutation(holders)[:k].tolist()) \
                if holders else set()
            got = [kv.lru_victim(exclude=exclude) for kv in (port, ref)]
            victims += got[0] is not None
        else:
            continue
        assert got[0] == got[1], op
        assert _state(port) == _state(ref)
    assert victims > 0


# --- the reference's cases (tests/test_kv_alloc.py) on the port's copy ---
def test_admit_grow_release_accounting():
    kv = PagedKVAllocator(8, block_size=4)
    assert kv.blocks_for(1) == 1 and kv.blocks_for(4) == 1
    assert kv.blocks_for(5) == 2 and kv.blocks_for(0) == 1

    assert kv.admit(0, 6)                 # 2 blocks
    assert kv.used_blocks == 2 and kv.free_blocks == 6
    assert kv.grow(0, 8)                  # still 2 blocks (8 tokens fit)
    assert kv.used_blocks == 2
    assert kv.grow(0, 9)                  # crosses a boundary -> 3rd block
    assert kv.used_blocks == 3
    assert kv.table(0).n_tokens == 9

    assert kv.release(0) == 3
    assert kv.free_blocks == kv.total_blocks == 8
    assert kv.stats["allocated_blocks"] == 3
    assert kv.stats["freed_blocks"] == 3
    assert kv.stats["peak_blocks_in_use"] == 3


def test_admit_rejects_without_partial_allocation():
    kv = PagedKVAllocator(4, block_size=4)
    assert kv.admit(0, 12)                # 3 of 4 blocks
    assert not kv.admit(1, 8)             # needs 2, only 1 free
    assert kv.free_blocks == 1            # nothing leaked
    assert kv.table(1) is None
    assert kv.stats["failed_grows"] == 1


def test_grow_rejects_without_partial_allocation():
    kv = PagedKVAllocator(4, block_size=4)
    assert kv.admit(0, 4)
    assert kv.admit(1, 8)
    assert not kv.grow(0, 16)             # needs 3 more, only 1 free
    assert kv.table(0).n_tokens == 4      # untouched on failure
    assert len(kv.table(0).blocks) == 1
    assert kv.free_blocks == 1
    assert kv.stats["failed_grows"] == 1


def test_double_admit_raises():
    kv = PagedKVAllocator(4)
    assert kv.admit(7, 1)
    with pytest.raises(ValueError):
        kv.admit(7, 1)


def test_lru_victim_ordering():
    kv = PagedKVAllocator(16, block_size=4)
    kv.admit(0, 4, priority=0, tick=0)
    kv.admit(1, 4, priority=0, tick=0)
    kv.admit(2, 4, priority=0, tick=0)
    kv.grow(0, 5, tick=5)                 # rid 0 touched most recently
    # rids 1 and 2 are equally stale; the tie breaks toward the newer
    # admission (rid 2) so the older request keeps its accumulated work
    assert kv.lru_victim() == 2
    kv.grow(2, 5, tick=3)
    assert kv.lru_victim() == 1           # now strictly least recent
    # priority beats admission order among equally recent holders
    kv.admit(3, 4, priority=-1, tick=3)
    kv.grow(1, 5, tick=3)
    assert kv.lru_victim() == 3
    # exclusions and empty pool
    assert kv.lru_victim(exclude={0, 1, 2, 3}) is None


def test_snapshot_shape():
    kv = PagedKVAllocator(8, block_size=2)
    kv.admit(0, 3)
    snap = kv.snapshot()
    assert snap == {"total_blocks": 8, "block_size": 2, "used_blocks": 2,
                    "free_blocks": 6, "peak_blocks_in_use": 2,
                    "failed_grows": 0}


def test_invalid_pool_raises():
    for cls in (PagedKVAllocator, JPagedKVAllocator):
        with pytest.raises(ValueError):
            cls(0)
        with pytest.raises(ValueError):
            cls(4, block_size=0)

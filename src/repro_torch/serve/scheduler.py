"""Continuous-batching serve scheduler: live-traffic admission in front
of the device-resident decode loop.  Port of ``repro.serve.scheduler``.

:class:`ServeScheduler` extends :class:`repro_torch.serve.ServeEngine`
with the pieces a static slot model lacks:

* **Arrival process** — requests carry an arrival time
  (:meth:`submit_at`); pending arrivals are released into the ready
  queue as the engine clock passes them, and new requests enter freed
  slots *mid-decode* on the very tick the slot frees, through the
  engine's bucketed prefill and in-place slot insert.
* **SLO-aware admission** — the ready queue is ordered by
  ``Request.priority`` (higher first, FIFO within a class).  A request
  whose TTFT deadline (``deadline_ms``, defaulted from
  ``slo_deadline_ms``) has already expired while queued is *shed*
  instead of wasting a slot on an answer nobody is waiting for.
* **Paged KV budgeting** — logical cache capacity comes from a
  :class:`repro_torch.serve.kv_alloc.PagedKVAllocator` pool that may be
  smaller than ``slots * cache_len``.  Admission reserves blocks for the
  prompt; each decode tick grows the table by the new token.  When the
  pool is exhausted the LRU victim is evicted: its blocks are recycled,
  and the request is re-queued to resume later by re-prefilling
  ``prompt + generated`` (greedy decode resumes token-for-token
  identically in f32 — vLLM-style recompute preemption).
* **Token streaming** — per-request ``on_token`` callbacks fire from the
  host loop, and :meth:`stream` yields tokens as the host sees them.

The physical decode state is untouched: fixed-shape slot tensors, the
in-place decode step and bucketed prefill are all inherited, so every
(re-)prefill runs the engine's prefill kernels (flash attention in the
attention layers, the SSD scan in the SSD layers) exactly as a first
admission does.  Runs on ``cuda`` unless ``device`` says otherwise.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.serve.engine import (DONE, QUEUED, SHED, Clock, Request,
                                      ServeEngine, validate_request)
from repro_torch.serve.kv_alloc import PagedKVAllocator


class ServeScheduler(ServeEngine):
    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 cache_len: int = 256, greedy: bool = True, seed: int = 0,
                 min_bucket: int = 8, clock: Optional[Clock] = None,
                 max_kv_blocks: Optional[int] = None,
                 kv_block_size: int = 16,
                 slo_deadline_ms: Optional[float] = None, device=None):
        super().__init__(cfg, params, slots=slots, cache_len=cache_len,
                         greedy=greedy, seed=seed, min_bucket=min_bucket,
                         clock=clock, device=device)
        if max_kv_blocks is None:
            # default pool covers every slot at full depth (no eviction
            # pressure unless the caller opts into oversubscription)
            max_kv_blocks = slots * (-(-cache_len // kv_block_size))
        self.kv = PagedKVAllocator(max_kv_blocks, kv_block_size)
        if self.kv.total_blocks * self.kv.block_size < cache_len:
            raise ValueError(
                f"max_kv_blocks={max_kv_blocks} x block_size="
                f"{kv_block_size} cannot hold even one full-depth request "
                f"(cache_len={cache_len}) — a lone request could deadlock")
        self.slo_deadline_ms = slo_deadline_ms
        self.shed: List[Request] = []
        # (arrival_time, seq, request) — released into `queue` by time
        self._pending: List[Tuple[float, int, Request]] = []
        self._seq = itertools.count()
        self._order: Dict[int, int] = {}       # rid -> submit order
        self.stats["shed"] = 0
        self.stats["evictions"] = 0

    # --------------------------------------------------------- arrivals
    def submit(self, req: Request):
        if req.deadline_ms is None:
            req.deadline_ms = self.slo_deadline_ms
        self._order.setdefault(req.rid, next(self._seq))
        super().submit(req)

    def submit_at(self, req: Request, arrival_time: float):
        """Schedule an open-loop arrival: the request joins the ready
        queue once the engine clock reaches ``arrival_time``."""
        validate_request(req, self.cache_len)   # fail at submit, not later
        if req.t_submit is None:
            req.t_submit = float(arrival_time)   # TTFT counts from arrival
        heapq.heappush(self._pending, (float(arrival_time),
                                       next(self._seq), req))

    def submit_trace(self, trace: Iterable[Tuple[float, Request]]):
        for t, req in trace:
            self.submit_at(req, t)

    def _release_arrivals(self):
        now = self.clock.now()
        while self._pending and self._pending[0][0] <= now:
            _, _, req = heapq.heappop(self._pending)
            self.submit(req)

    def next_arrival(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    # -------------------------------------------------------- admission
    def _shed_expired(self):
        """Drop queued requests whose TTFT deadline already passed — a
        slot spent on them is goodput denied to a request that can still
        make its SLO."""
        now = self.clock.now()
        keep = []
        for req in self.queue:
            # requests with a first token already out (eviction resumes)
            # have met or missed their TTFT SLO — shedding them now would
            # throw away delivered work, so they always re-run
            if (req.t_first is None
                    and req.deadline_ms is not None
                    and req.t_submit is not None
                    and (now - req.t_submit) * 1e3 > req.deadline_ms):
                req.status = SHED
                req.t_done = now
                self.shed.append(req)
                self.stats["shed"] += 1
                if req.on_token:
                    req.on_token(req, -1, True)
            else:
                keep.append(req)
        self.queue = keep

    def _select_admissions(self) -> List:
        self._release_arrivals()
        self._shed_expired()
        free = [s for s in range(self.slots) if self.active[s] is None]
        if not free or not self.queue:
            return []
        # priority queue: higher priority first, FIFO within a class
        self.queue.sort(key=lambda r: (-r.priority, self._order[r.rid]))
        pairs, deferred = [], []
        for req in self.queue:
            if not free:
                deferred.append(req)
                continue
            need = len(self._prompt_tokens(req)) + 1
            if not self.kv.admit(req.rid, need, priority=req.priority,
                                 tick=self._tick):
                # pool exhausted: head-of-line waits for blocks to recycle
                deferred.append(req)
                continue
            pairs.append((free.pop(0), req))
        self.queue = deferred
        return pairs

    def _prompt_tokens(self, req: Request) -> np.ndarray:
        """Eviction resume: the whole history (prompt + tokens generated
        before eviction) is re-prefilled as the new prompt; greedy decode
        then continues where it left off."""
        prompt = np.asarray(req.prompt)
        if req.generated:
            return np.concatenate(
                [prompt, np.asarray(req.generated, prompt.dtype)])
        return prompt

    # ------------------------------------------------------- retirement
    def _retire(self, slot: int, req: Request):
        if self.kv.table(req.rid) is not None:
            self.kv.release(req.rid)
        super()._retire(slot, req)

    def _evict(self, slot: int, req: Request):
        """Recycle a running request's blocks and re-queue it: it resumes
        later by re-prefilling prompt + generated."""
        self.kv.release(req.rid)
        self.active[slot] = None
        req.status = QUEUED
        req.evictions += 1
        self.stats["evictions"] += 1
        history = len(req.prompt) + len(req.generated)
        if history >= self.cache_len - 1:
            # no room left to resume — it was about to hit the cache
            # bound anyway; retire it as done instead of looping forever
            req.done = True
            req.status = DONE
            req.t_done = self.clock.now()
            self.completed.append(req)
        else:
            self.queue.append(req)

    def _ensure_decode_capacity(self):
        """Before a decode tick, every active request needs its next
        token's cache row covered by the block pool; evict LRU victims
        until every survivor fits."""
        evicted = False
        for slot in range(self.slots):
            req = self.active[slot]
            if req is None:
                continue
            need = int(self._host_pos[slot]) + 1
            while not self.kv.grow(req.rid, need, tick=self._tick):
                victim_rid = self.kv.lru_victim(exclude={req.rid})
                if victim_rid is None:       # nobody else to evict
                    self._evict(slot, req)
                    evicted = True
                    break
                vslot = next(s for s, r in enumerate(self.active)
                             if r is not None and r.rid == victim_rid)
                self._evict(vslot, self.active[vslot])
                evicted = True
        if evicted:
            self._sync_slot_meta()

    # ------------------------------------------------------------ drive
    def step(self) -> bool:
        self._admit()
        self._ensure_decode_capacity()
        return self._decode_tick()

    def idle(self) -> bool:
        return (not self._pending and not self.queue
                and all(r is None for r in self.active))

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Drive the engine until every submitted request is done or
        shed.  Open-loop: between now and a future arrival with nothing
        active, the clock sleeps forward instead of busy-spinning."""
        for _ in range(max_steps):
            progressed = self.step()
            if self.idle():
                break
            if not progressed and not self.queue:
                nxt = self.next_arrival()
                if nxt is not None:
                    self.clock.sleep_until(nxt)
        return self.completed

    run_trace = run

    # -------------------------------------------------------- streaming
    def stream(self, req: Request, max_steps: int = 100_000) \
            -> Iterator[int]:
        """Yield ``req``'s tokens as the host sees them, driving the
        engine (and every co-batched request) underneath.  TTFT is
        measured at the first yield; a shed request yields nothing."""
        if (req.status == QUEUED and req not in self.queue
                and all(req is not p[2] for p in self._pending)):
            self.submit(req)
        emitted = 0
        for _ in range(max_steps):
            while emitted < len(req.generated):
                yield req.generated[emitted]
                emitted += 1
            if req.done or req.status == SHED:
                return
            if not self.step() and not self.queue:
                nxt = self.next_arrival()
                if nxt is None:
                    return           # nothing left anywhere
                self.clock.sleep_until(nxt)

    # ------------------------------------------------------------ stats
    def _stats_extra(self) -> Dict[str, object]:
        done = [r for r in self.completed if r.status == DONE]
        return {
            "shed": self.stats["shed"],
            "evictions": self.stats["evictions"],
            "slo_met": sum(r.met_deadline() for r in done),
            "kv": self.kv.snapshot(),
        }

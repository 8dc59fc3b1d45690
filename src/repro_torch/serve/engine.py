"""Batched serving engine: slot-based batching over the model's prefill and
decode steps, with the hot path on the device.  Port of
``repro.serve.engine``.

Requests are admitted into fixed decode slots; each engine step decodes one
token for every active slot.  Finished slots (EOS, max_tokens or the cache
bound) are refilled from the queue.

As in the reference:
  * sampling (greedy, or temperature/top-k from a seeded
    ``torch.Generator``) runs on the device inside the decode step, so only
    the (slots,) token ids and done flags cross to the host each token;
  * prefill pads prompts to power-of-two buckets (capped at ``cache_len``)
    and runs one fixed (slots, bucket) batch per bucket, rows beyond the
    group being dummies of length 0;
  * ``submit`` rejects empty prompts and prompts that cannot fit the cache.

PyTorch runs eagerly, so there is nothing to compile: where the reference
donates the decode state to a jitted step, the port updates the KV caches
and the per-slot ``last_token``/``positions`` tensors in place, and the
donated slot insert becomes an in-place indexed copy of the prefilled rows
into their decode-state slots (the KV caches of a dense stack, the SSM and
conv states of an SSM stack).  The summary reports the launches of the
prefill kernels (flash attention, the SSD scan) in place of the
reference's compile counts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_fwd_kernel
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.models import (decode_and_sample, init_decode_state,
                                prefill_and_sample)

MIN_BUCKET = 8           # shortest prefill pad

# Request lifecycle states
QUEUED = "queued"        # submitted, waiting for a slot
RUNNING = "running"      # occupying a decode slot
DONE = "done"            # retired normally (EOS / max_tokens / cache bound)
SHED = "shed"            # dropped by SLO admission before getting a slot


class Clock:
    """Wall clock; swappable for a :class:`VirtualClock` in tests/benches."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)

    def on_step(self) -> None:     # virtual clocks advance per decode step
        pass


class VirtualClock(Clock):
    """Deterministic clock: time moves only when told to.  ``dt_per_step``
    makes every decode step cost a fixed amount of virtual time, so
    queue-wait / deadline behaviour is reproducible in tests."""

    def __init__(self, start: float = 0.0, dt_per_step: float = 0.0):
        self.t = float(start)
        self.dt_per_step = float(dt_per_step)

    def now(self) -> float:
        return self.t

    def sleep_until(self, t: float) -> None:
        self.t = max(self.t, float(t))

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def on_step(self) -> None:
        self.t += self.dt_per_step


@dataclasses.dataclass(eq=False)   # identity equality: prompts are arrays
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_tokens: int = 16
    eos_id: Optional[int] = None
    # per-request sampling knobs: temperature <= 0 decodes greedily
    # (subject to the engine-level ``greedy`` default); top_k == 0 samples
    # the full vocab.
    temperature: float = 0.0
    top_k: int = 0
    # scheduling knobs (JobSpec.priority semantics: higher runs first;
    # deadline_ms is a TTFT SLO measured from submit time — the scheduler
    # sheds requests that can no longer meet it)
    priority: int = 0
    deadline_ms: Optional[float] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = QUEUED
    evictions: int = 0
    # streaming: called as on_token(request, token_id, finished) from the
    # host bookkeeping loop the moment each token id reaches the host
    on_token: Optional[Callable[["Request", int, bool], None]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    # service timestamps (engine-clock seconds; filled by the engine)
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    # ------------------------------------------------- derived latencies
    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (submit -> first token on host)."""
        if self.t_first is None or self.t_submit is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token over the decode phase."""
        if self.t_done is None or self.t_first is None:
            return None
        return ((self.t_done - self.t_first)
                / max(1, len(self.generated) - 1))

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admit is None or self.t_submit is None:
            return None
        return self.t_admit - self.t_submit

    def met_deadline(self) -> bool:
        """Did the first token arrive within the TTFT SLO?"""
        if self.status != DONE:
            return False
        if self.deadline_ms is None:
            return True
        ttft = self.ttft_s
        return ttft is not None and ttft * 1e3 <= self.deadline_ms


def validate_request(req: Request, cache_len: int) -> None:
    """Reject prompts the engine cannot serve faithfully: empty prompts
    have no token to prefill from; prompts >= cache_len would silently
    lose their head to the ring buffer."""
    plen = len(req.prompt)
    if plen == 0:
        raise ValueError(f"request {req.rid}: empty prompt — a request "
                         f"needs at least one prompt token")
    if plen >= cache_len:
        raise ValueError(
            f"request {req.rid}: prompt length {plen} >= cache_len "
            f"{cache_len}; the cache holds at most cache_len - 1 prompt "
            f"tokens plus one generated token — shorten the prompt or "
            f"serve with a larger cache_len")


class EngineStats(dict):
    """The engine's raw counters (plain mapping access, e.g.
    ``stats["decode_steps"]``) that is also *callable*: ``stats()``
    returns a summary dict with per-request latency percentiles."""

    def __init__(self, engine: "ServeEngine", **counters):
        super().__init__(**counters)
        self._engine = engine

    def __call__(self) -> Dict[str, object]:
        return self._engine._stats_summary()


def _pctl(values: List[float], q: float) -> Optional[float]:
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    return round(float(np.percentile(np.asarray(vals, np.float64), q)), 6)


class ServeEngine:
    """Slot-based batching engine on one device (``cuda`` unless
    ``device`` says otherwise; without a card and without ``device`` it
    raises)."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 cache_len: int = 256, greedy: bool = True, seed: int = 0,
                 clock: Optional[Clock] = None, device=None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.greedy = greedy
        self.clock = clock or Clock()
        self.device = dev = resolve_device(device)

        self.state = init_decode_state(cfg, slots, cache_len, device=dev)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.completed: List[Request] = []

        # device-resident per-slot decode inputs (never pulled per token)
        self.last_token = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.positions = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._topks = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._eos = torch.full((slots,), -1, dtype=torch.int32, device=dev)
        # host bookkeeping mirror of positions (advanced analytically — no
        # device readback)
        self._host_pos = np.zeros(slots, np.int64)

        self._generator = torch.Generator(device=dev).manual_seed(seed)
        self._needs_sampling = False
        self.stats = EngineStats(
            self, decode_steps=0, host_transfer_bytes=0, prefill_calls=0,
            admitted=0, flash_attention_launches=0, ssd_scan_launches=0)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        validate_request(req, self.cache_len)
        if req.t_submit is None:
            req.t_submit = self.clock.now()
        req.status = QUEUED
        self.queue.append(req)

    def bucket(self, plen: int) -> int:
        """Power-of-two pad target for a prompt length, ≥ MIN_BUCKET and
        capped at cache_len (the longest admissible prompt)."""
        b = max(MIN_BUCKET, 1 << max(0, plen - 1).bit_length())
        return min(b, self.cache_len)

    def _effective_sampling(self, req: Request):
        temp = float(req.temperature)
        if temp <= 0.0 and not self.greedy:
            temp = 1.0
        return temp, int(req.top_k)

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # --------------------------------------------------- admission hooks
    def _prompt_tokens(self, req: Request) -> np.ndarray:
        """Tokens to prefill for an admitted request."""
        return np.asarray(req.prompt)

    def _select_admissions(self) -> List:
        """Admission policy: (slot, request) pairs to admit this tick —
        FIFO into free slots."""
        free = [s for s in range(self.slots) if self.active[s] is None]
        pairs = []
        while free and self.queue:
            pairs.append((free.pop(0), self.queue.pop(0)))
        return pairs

    def _admit(self):
        admitted = self._select_admissions()
        if not admitted:
            return
        self._fill_slots(admitted)
        self._sync_slot_meta()

    def _insert(self, pstate, src_row: np.ndarray, ptoks, lens):
        """Copy prefilled rows into engine slots in place: slot s takes
        prefill row src_row[s]; slots with src_row[s] < 0 keep theirs."""
        slots = np.nonzero(src_row >= 0)[0]
        dst = self._to_dev(slots)
        rows = self._to_dev(src_row[slots].astype(np.int64))
        for name, t in self.state.items():
            t[:, dst] = pstate[name][:, rows]
        self.last_token[dst] = ptoks[rows]
        self.positions[dst] = lens[rows]

    def _fill_slots(self, admitted: List):
        """Prefill + insert the selected (slot, request) pairs, grouped by
        pad bucket."""
        groups: Dict[int, list] = {}
        for slot, req in admitted:
            toks_np = self._prompt_tokens(req)
            plen = min(len(toks_np), self.cache_len - 1)
            groups.setdefault(self.bucket(plen), []).append(
                (slot, req, toks_np, plen))

        for bucket, grp in sorted(groups.items()):
            # fixed (slots, bucket) prefill batch — rows beyond the group
            # are dummies (length 0, state discarded by the insert)
            toks = np.zeros((self.slots, bucket), np.int32)
            lens = np.zeros(self.slots, np.int32)
            temps = np.zeros(self.slots, np.float32)
            topks = np.zeros(self.slots, np.int32)
            src_row = np.full(self.slots, -1, np.int32)
            for r, (slot, req, toks_np, plen) in enumerate(grp):
                toks[r, :plen] = toks_np[-plen:]
                lens[r] = plen
                temps[r], topks[r] = self._effective_sampling(req)
                src_row[slot] = r
            lens_d = self._to_dev(lens)
            fa0, ssd0 = (flash_attention_fwd_kernel.launches,
                         ssd_scan_kernel.launches)
            ptoks, pstate = prefill_and_sample(
                self.params, self.cfg, {"tokens": self._to_dev(toks)},
                cache_len=self.cache_len, generator=self._generator,
                temperature=self._to_dev(temps), top_k=self._to_dev(topks),
                lengths=lens_d)
            self._insert(pstate, src_row, ptoks, lens_d)
            del pstate
            first = ptoks.cpu().numpy()        # (slots,) — admit-time only
            self.stats["prefill_calls"] += 1
            self.stats["flash_attention_launches"] += (
                flash_attention_fwd_kernel.launches - fa0)
            self.stats["ssd_scan_launches"] += ssd_scan_kernel.launches - ssd0
            now = self.clock.now()
            for r, (slot, req, toks_np, plen) in enumerate(grp):
                self.active[slot] = req
                req.status = RUNNING
                if req.t_admit is None:
                    req.t_admit = now
                tok = int(first[r])
                req.generated.append(tok)
                if req.t_first is None:
                    req.t_first = now
                self._host_pos[slot] = plen
                self.stats["admitted"] += 1
                finished = len(req.generated) >= req.max_tokens
                if finished:
                    self._retire(slot, req)
                if req.on_token:
                    req.on_token(req, tok, finished)

    def _sync_slot_meta(self):
        """Refresh the per-slot sampling/EOS device tensors (admit-time
        host→device upload; nothing here runs per token)."""
        temps = np.zeros(self.slots, np.float32)
        topks = np.zeros(self.slots, np.int32)
        eos = np.full(self.slots, -1, np.int32)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            temps[slot], topks[slot] = self._effective_sampling(req)
            if req.eos_id is not None:
                eos[slot] = req.eos_id
        self._temps = self._to_dev(temps)
        self._topks = self._to_dev(topks)
        self._eos = self._to_dev(eos)
        self._needs_sampling = bool((temps > 0.0).any())

    # ------------------------------------------------------- retirement
    def _retire(self, slot: int, req: Request):
        """Free a slot whose request finished normally."""
        req.done = True
        req.status = DONE
        req.t_done = self.clock.now()
        self.completed.append(req)
        self.active[slot] = None

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One decode step across all active slots.  Returns whether a
        decode actually ran (False: nothing active after admission)."""
        self._admit()
        return self._decode_tick()

    def _decode_tick(self) -> bool:
        """Decode one token for every active slot (no admission)."""
        if not any(r is not None for r in self.active):
            return False
        tok, _ = decode_and_sample(
            self.params, self.cfg, self.state, self.last_token[:, None],
            self.positions, self._generator, self._temps, self._topks,
            greedy_only=not self._needs_sampling)
        self.last_token.copy_(tok)
        self.positions += 1
        eos_hit = tok == self._eos
        # the ONLY per-token device→host transfer: token ids + done flags
        tok_h = tok.cpu().numpy()
        eos_h = eos_hit.cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["host_transfer_bytes"] += tok_h.nbytes + eos_h.nbytes
        self._host_pos += 1
        self.clock.on_step()

        retired = False
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok_i = int(tok_h[slot])
            req.generated.append(tok_i)
            finished = (bool(eos_h[slot])
                        or len(req.generated) >= req.max_tokens
                        or self._host_pos[slot] >= self.cache_len - 1)
            if finished:
                self._retire(slot, req)
                retired = True
            if req.on_token:
                req.on_token(req, tok_i, finished)
        if retired:
            self._sync_slot_meta()
        return True

    def run(self, max_steps: int = 1000) -> List[Request]:
        for _ in range(max_steps):
            self.step()
            if not self.queue and all(r is None for r in self.active):
                break
        return self.completed

    # ------------------------------------------------------------ stats
    def _stats_summary(self) -> Dict[str, object]:
        done = [r for r in self.completed if r.status == DONE]
        ttft = [r.ttft_s for r in done]
        tpot = [r.tpot_s for r in done]
        qwait = [r.queue_wait_s for r in done]
        return {
            "completed": len(done),
            "queued": len(self.queue),
            "running": sum(r is not None for r in self.active),
            "decode_steps": self.stats["decode_steps"],
            "prefill_calls": self.stats["prefill_calls"],
            "admitted": self.stats["admitted"],
            "host_transfer_bytes": self.stats["host_transfer_bytes"],
            "flash_attention_launches":
                self.stats["flash_attention_launches"],
            "ssd_scan_launches": self.stats["ssd_scan_launches"],
            "evictions": sum(r.evictions for r in done),
            "ttft_p50_s": _pctl(ttft, 50), "ttft_p99_s": _pctl(ttft, 99),
            "tpot_p50_s": _pctl(tpot, 50), "tpot_p99_s": _pctl(tpot, 99),
            "queue_wait_p50_s": _pctl(qwait, 50),
            "queue_wait_p99_s": _pctl(qwait, 99),
        }

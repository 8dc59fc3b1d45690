"""Open-loop load generation for the serve scheduler.  The port's own copy
of ``repro.serve.loadgen``: the same seed gives the same arrival times,
prompts, priorities and deadlines as the reference, bit for bit.

Open-loop means arrivals follow the trace's clock regardless of how the
server is keeping up — the regime that actually stresses admission,
shedding and eviction (a closed-loop driver self-throttles and can never
overload the engine).  Two arrival processes:

* :func:`poisson_trace` — exponential inter-arrival gaps at a target
  mean rate (the classic steady-traffic model);
* :func:`bursty_trace` — arrivals grouped into near-simultaneous bursts
  separated by idle gaps (same mean rate, much worse tail behaviour —
  flash-crowd traffic).

Both return a sorted ``[(arrival_time_s, Request), ...]`` list with
deterministic prompts/lengths per seed, ready for
``ServeScheduler.submit_trace`` or for replaying against the static
:class:`~repro_torch.serve.ServeEngine` baseline.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Request

Trace = List[Tuple[float, Request]]


def _requests(vocab: int, n: int, rng: np.random.Generator, *,
              plen_range: Tuple[int, int], max_tokens: int,
              priorities: Sequence[int], deadline_ms: Optional[float],
              rid_base: int) -> List[Request]:
    lo, hi = plen_range
    return [
        Request(rid=rid_base + i,
                prompt=rng.integers(0, vocab,
                                    size=int(rng.integers(lo, hi + 1))),
                max_tokens=max_tokens,
                priority=int(priorities[int(rng.integers(
                    0, len(priorities)))]),
                deadline_ms=deadline_ms)
        for i in range(n)
    ]


def poisson_trace(vocab: int, n: int, rate_qps: float, *, seed: int = 0,
                  plen_range: Tuple[int, int] = (4, 24),
                  max_tokens: int = 16,
                  priorities: Sequence[int] = (0,),
                  deadline_ms: Optional[float] = None,
                  rid_base: int = 0, start: float = 0.0) -> Trace:
    """n arrivals with Exp(1/rate) inter-arrival gaps (mean rate_qps)."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be positive, got {rate_qps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_qps, size=n)
    times = start + np.cumsum(gaps)
    reqs = _requests(vocab, n, rng, plen_range=plen_range,
                     max_tokens=max_tokens, priorities=priorities,
                     deadline_ms=deadline_ms, rid_base=rid_base)
    return list(zip(times.tolist(), reqs))


def bursty_trace(vocab: int, n: int, rate_qps: float, *, seed: int = 0,
                 burst_size: int = 4, jitter_s: float = 1e-3,
                 plen_range: Tuple[int, int] = (4, 24),
                 max_tokens: int = 16,
                 priorities: Sequence[int] = (0,),
                 deadline_ms: Optional[float] = None,
                 rid_base: int = 0, start: float = 0.0) -> Trace:
    """Same mean rate as :func:`poisson_trace`, but arrivals land in
    bursts of ``burst_size`` (small intra-burst jitter) separated by
    Exp(burst_size/rate) gaps — flash-crowd tails."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be positive, got {rate_qps}")
    if burst_size <= 0:
        raise ValueError(f"burst_size must be positive, got {burst_size}")
    rng = np.random.default_rng(seed)
    n_bursts = -(-n // burst_size)
    burst_gaps = rng.exponential(burst_size / rate_qps, size=n_bursts)
    burst_t = start + np.cumsum(burst_gaps)
    times = []
    for b in range(n_bursts):
        k = min(burst_size, n - len(times))
        times.extend((burst_t[b] + rng.uniform(0, jitter_s, size=k))
                     .tolist())
    times.sort()
    reqs = _requests(vocab, n, rng, plen_range=plen_range,
                     max_tokens=max_tokens, priorities=priorities,
                     deadline_ms=deadline_ms, rid_base=rid_base)
    return list(zip(times, reqs))


def make_trace(kind: str, vocab: int, n: int, rate_qps: float,
               **kw) -> Trace:
    """Dispatch by name ('poisson' | 'bursty') — the CLI/bench surface."""
    if kind == "poisson":
        return poisson_trace(vocab, n, rate_qps, **kw)
    if kind == "bursty":
        return bursty_trace(vocab, n, rate_qps, **kw)
    raise ValueError(f"unknown trace kind {kind!r} "
                     f"(expected 'poisson' or 'bursty')")

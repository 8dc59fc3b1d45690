"""Device time of a step from a ``torch.profiler`` trace (the port's
counterpart of ``repro.analysis.hlo``).

The reference counts collective bytes in a step's partitioned HLO text and
scales the ones inside ``while`` bodies by their trip counts.  The port
compiles no HLO: its collectives are counted where they are issued
(:class:`repro_torch.distributed.DistContext` counts each all-reduce's
bytes and seconds), and what its kernels did is seen in a trace of the
card.  :func:`device_profile` runs a callable under the profiler and
returns the device's time by kernel, its busy time, its idle share of the
wall time and the peak memory.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch


def device_profile(run: Callable[[], object], top: int = 8) -> Dict:
    """``run()`` once under ``torch.profiler``, CUDA activity only (tracing
    every aten op on the host as well slows the host loop being measured
    and takes several times longer to aggregate, for the same device
    time).

    Returns ``wall_ms`` (host clock around ``run`` and a synchronize),
    ``device_busy_ms`` (the device-side events' self time: kernels and
    copies, not the runtime's calls), ``idle_share`` (1 - busy / wall),
    ``top`` (the ``top`` longest ops by device ms, with their calls),
    ``kernels`` (every op's device ms and calls, by name) and
    ``peak_mem_gb`` (``torch.cuda.max_memory_allocated`` over the run).
    Raises ``RuntimeError`` without a card: the numbers are the device's.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("device_profile traces a CUDA device; none is "
                           "available")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = sorted(((ev.self_device_time_total / 1e3, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else 0.0,
            "top": [{"op": key[:60], "ms": ms, "calls": n}
                    for ms, key, n in rows[:top]],
            "kernels": {key: {"ms": ms, "calls": n} for ms, key, n in rows},
            "peak_mem_gb": peak_gb}

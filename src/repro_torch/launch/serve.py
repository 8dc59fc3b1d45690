"""Serving launcher: batched decoding over synthetic requests.

``python -m repro_torch.launch.serve --arch granite-3-2b --requests 16``
``python -m repro_torch.launch.serve --arch mamba2-2.7b``
``python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b`` (also
``jamba-1.5-large-398b``, ``llama4-maverick-400b-a17b``)
``python -m repro_torch.launch.serve --arrival-rate 50 --max-kv-blocks 16
--kv-block-size 8``

Port of ``repro.launch.serve``.  Like the reference it serves the reduced
config of ``arch`` with random weights from ``seed``, in one of two modes:

* **static batch** (default, ``--arrival-rate 0``): every request is
  queued up front and the :class:`~repro_torch.serve.ServeEngine` drains
  them — the closed-loop throughput measurement.
* **continuous** (``--arrival-rate > 0`` requests/s): an open-loop
  Poisson or bursty arrival trace (``--trace``) drives the
  :class:`~repro_torch.serve.ServeScheduler` — continuous admission into
  freed slots mid-decode, SLO shedding (``--slo-deadline-ms``), and
  paged-KV budgeting/eviction (``--max-kv-blocks``, ``--kv-block-size``).

Both report per-request service timing (TTFT / TPOT / queue-wait
percentiles).  Where the reference reports its jit compile counts
(``prefill_compiles``, ``decode_compiles``), the port, which runs
eagerly, reports ``prefill_calls`` and the launches of the prefill
kernels.  Runs on ``cuda`` unless ``device`` (``--device``) says
otherwise.  The command line is a thin shim over the port's run API
(``python -m repro_torch.launch run serve`` is the same run): it prints
the report's metrics as JSON and exits 1 if the run failed.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.kernels.common import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import (Request, ServeEngine, ServeScheduler,
                               make_trace, require_text_serving)


def _timing_metrics(stats_summary: dict) -> dict:
    keys = ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
            "queue_wait_p50_s", "queue_wait_p99_s", "evictions")
    return {k: stats_summary.get(k) for k in keys}


def serve_main(arch: str, *, requests: int = 16, slots: int = 4,
               cache_len: int = 128, max_tokens: int = 16,
               seed: int = 0, temperature: float = 0.0,
               top_k: int = 0, arrival_rate: float = 0.0,
               trace: str = "poisson", slo_deadline_ms: float = 0.0,
               max_kv_blocks: int = 0, kv_block_size: int = 16,
               device=None) -> dict:
    cfg = get_reduced(arch)
    require_text_serving(cfg)          # before any weight reaches the card
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)

    if arrival_rate > 0:
        return _serve_continuous(
            cfg, params, requests=requests, slots=slots,
            cache_len=cache_len, max_tokens=max_tokens, seed=seed,
            temperature=temperature, top_k=top_k,
            arrival_rate=arrival_rate, trace=trace,
            slo_deadline_ms=slo_deadline_ms, max_kv_blocks=max_kv_blocks,
            kv_block_size=kv_block_size, device=device)

    engine = ServeEngine(cfg, params, slots=slots, cache_len=cache_len,
                         seed=seed, device=device)
    rng = np.random.default_rng(seed)
    for i in range(requests):
        engine.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab,
                                       size=int(rng.integers(4, 24))),
            max_tokens=max_tokens, temperature=temperature, top_k=top_k))
    t0 = time.time()
    done = engine.run()
    wall = time.time() - t0
    tokens = sum(len(r.generated) for r in done)
    s = engine.stats()
    return {
        "arch": cfg.name, "mode": "static", "device": str(device),
        "requests": len(done),
        "tokens": tokens,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(tokens / wall, 2),
        "slots": slots,
        "decode_steps": s["decode_steps"],
        "prefill_calls": s["prefill_calls"],
        "flash_attention_launches": s["flash_attention_launches"],
        "ssd_scan_launches": s["ssd_scan_launches"],
        "host_transfer_bytes": s["host_transfer_bytes"],
        **_timing_metrics(s),
    }


def _serve_continuous(cfg, params, *, requests, slots, cache_len,
                      max_tokens, seed, temperature, top_k, arrival_rate,
                      trace, slo_deadline_ms, max_kv_blocks, kv_block_size,
                      device) -> dict:
    sched = ServeScheduler(
        cfg, params, slots=slots, cache_len=cache_len, seed=seed,
        max_kv_blocks=max_kv_blocks or None, kv_block_size=kv_block_size,
        slo_deadline_ms=slo_deadline_ms or None, device=device)
    items = make_trace(trace, cfg.vocab, requests, arrival_rate,
                       seed=seed, max_tokens=max_tokens)
    for _, req in items:
        req.temperature, req.top_k = temperature, top_k
    t0 = sched.clock.now()
    sched.submit_trace([(t0 + t, r) for t, r in items])
    done = sched.run()
    wall = sched.clock.now() - t0
    s = sched.stats()
    tokens = sum(len(r.generated) for r in done)
    slo_tokens = sum(len(r.generated) for r in done if r.met_deadline())
    return {
        "arch": cfg.name, "mode": "continuous", "device": str(device),
        "trace": trace, "arrival_rate_qps": arrival_rate,
        "requests": requests, "completed": s["completed"],
        "shed": s["shed"], "slo_met": s["slo_met"],
        "tokens": tokens,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(tokens / max(wall, 1e-9), 2),
        "goodput_req_s": round(s["slo_met"] / max(wall, 1e-9), 3),
        "goodput_tok_s": round(slo_tokens / max(wall, 1e-9), 2),
        "slots": slots,
        "decode_steps": s["decode_steps"],
        "prefill_calls": s["prefill_calls"],
        "flash_attention_launches": s["flash_attention_launches"],
        "ssd_scan_launches": s["ssd_scan_launches"],
        "kv": s["kv"],
        **_timing_metrics(s),
    }


def main(argv=None):
    # thin shim over the repro_torch.api registry (RunSpec in, RunReport out)
    from repro_torch.api import RunSpec, run

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop offered load in requests/s "
                         "(0 = static batch mode)")
    ap.add_argument("--trace", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--slo-deadline-ms", type=float, default=0.0,
                    help="TTFT SLO; queued requests past it are shed "
                         "(0 = no deadline)")
    ap.add_argument("--max-kv-blocks", type=int, default=0,
                    help="paged KV pool size in blocks "
                         "(0 = slots*cache_len, no oversubscription)")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    overrides = {
        "requests": args.requests, "slots": args.slots,
        "cache_len": args.cache_len, "max_tokens": args.max_tokens,
        "temperature": args.temperature, "top_k": args.top_k,
        "arrival_rate": args.arrival_rate, "trace": args.trace,
        "slo_deadline_ms": args.slo_deadline_ms,
        "max_kv_blocks": args.max_kv_blocks,
        "kv_block_size": args.kv_block_size}
    if args.device is not None:
        overrides["device"] = args.device
    report = run(RunSpec(kind="serve", arch=args.arch, overrides=overrides))
    print(json.dumps(report.metrics, indent=1))
    if not report.ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

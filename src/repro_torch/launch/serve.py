"""Serving launcher: batched decoding over synthetic requests.

``python -m repro_torch.launch.serve --arch granite-3-2b --requests 16``
``python -m repro_torch.launch.serve --arch mamba2-2.7b``

Port of the static-batch mode of ``repro.launch.serve``: every request is
queued up front and the :class:`~repro_torch.serve.ServeEngine` drains
them.  Like the reference it serves the reduced config of ``arch`` with
random weights from ``seed``.  Continuous mode (``arrival_rate > 0``)
needs the scheduler, which is not ported yet, and raises.  Runs on
``cuda`` unless ``device`` (``--device``) says otherwise.
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
from repro_torch.serve import Request, ServeEngine


def _timing_metrics(stats_summary: dict) -> dict:
    keys = ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
            "queue_wait_p50_s", "queue_wait_p99_s", "evictions")
    return {k: stats_summary.get(k) for k in keys}


def serve_main(arch: str, *, requests: int = 16, slots: int = 4,
               cache_len: int = 128, max_tokens: int = 16,
               seed: int = 0, temperature: float = 0.0,
               top_k: int = 0, arrival_rate: float = 0.0,
               device=None) -> dict:
    if arrival_rate > 0:
        raise NotImplementedError("continuous serving (arrival_rate > 0) "
                                  "needs the scheduler, not ported yet")
    device = resolve_device(device)
    cfg = get_reduced(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device=device)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop offered load in requests/s; only 0 "
                         "(static batch) is ported")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    metrics = serve_main(
        args.arch, requests=args.requests, slots=args.slots,
        cache_len=args.cache_len, max_tokens=args.max_tokens,
        temperature=args.temperature, top_k=args.top_k,
        arrival_rate=args.arrival_rate, device=args.device)
    print(json.dumps(metrics, indent=1))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. print the card's name and power limit; build the flash-attention
   forward kernel from ``src/repro_torch/.../csrc`` with nvcc (sm_90a);
2. hold the kernel against its plain PyTorch version on the card, in bf16
   and f32, at granite-3-2b's prefill shape and at ragged, windowed and
   MHA hd=128 shapes: O and LSE within stated tolerances, with the
   kernel's, the plain version's and the library call's times and the
   least time the card could take (one JSON line per shape);
3. serve full-width granite-3-2b (40 layers, bf16, random weights from a
   seed) through ``ServeEngine``: 16 greedy requests, prompts of 16-1500
   tokens, 32 new tokens each, 8 slots; the kernel's launches must equal
   40 x prefill calls; then one prefill batch through the kernel and
   through the plain attention, each held against an f32 prefill on the
   last logits; then ``torch.profiler`` over one prefill and 8 decode
   steps (device time by operation, idle share);
4. run ``serve_main("granite-3-2b")`` (the reduced CLI path) on the card.

The line before the last lists each ported kernel with its launches on
the main path (phase 3) and its numbers at granite's prefill shape; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
without the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:57"

# H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# name, B, Sq, Sk, H, Kh, hd, causal, window
SHAPES = [
    ("granite_prefill", 8, 2048, 2048, 32, 8, 64, True, None),
    ("ragged_s1000", 2, 1000, 1000, 32, 8, 64, True, None),
    ("window_512", 2, 2048, 2048, 32, 8, 64, True, 512),
    ("mha_hd128", 2, 1024, 1024, 16, 16, 128, True, None),
]
# kernel vs plain in the working dtype: f32 differs only by summation
# order; bf16 adds the output's rounding to bf16 (~4e-3 relative)
TOL = {"float32": {"o": 2e-5, "lse": 1e-4},
       "bfloat16": {"o": 2e-2, "lse": 1e-4}}


def emit(**rec):
    print(json.dumps(rec), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def valid_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Number of (q, k) pairs the mask admits — the work this input needs."""
    q = np.arange(sq)
    hi = np.minimum(sk - 1, q) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def bound(B, Sq, Sk, H, Kh, hd, causal, window, dtype: str, esize: int):
    """Least time (ms) for the forward: operations (QK^T and PV, 2 flops
    per multiply-add each) over the dtype's peak, or bytes (q, k, v read
    once, o and the f32 LSE written once) over HBM bandwidth."""
    flops = 4 * hd * valid_pairs(Sq, Sk, causal, window) * B * H
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * Kh * hd) * esize \
        + 4 * B * H * Sq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def kernel_vs_plain(torch, F, fa_kernel, attention_ref):
    """Phase 2.  Returns the granite-shape bf16 record."""
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, B, Sq, Sk, H, Kh, hd, causal, window in SHAPES:
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
            q, k, v = rnd(B, Sq, H, hd), rnd(B, Sk, Kh, hd), rnd(B, Sk, Kh, hd)
            out, lse = fa_kernel(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ref_out, ref_lse = attention_ref(q, k, v, causal=causal,
                                             window=window)
            err_o = (out.float() - ref_out.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            tol = TOL[dtype_name]
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       atol=tol["o"], rtol=tol["o"])
            torch.testing.assert_close(lse, ref_lse, atol=tol["lse"],
                                       rtol=tol["lse"])
            del ref_out, ref_lse

            kernel_ms = cuda_ms(torch, lambda: fa_kernel(
                q, k, v, causal=causal, window=window), reps=10)
            plain_ms = cuda_ms(torch, lambda: attention_ref(
                q, k, v, causal=causal, window=window), reps=2)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if window is None:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            else:
                qp = torch.arange(Sq, device="cuda")[:, None]
                kp = torch.arange(Sk, device="cuda")[None, :]
                mask = (kp <= qp) & (kp > qp - window)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            library_ms = cuda_ms(torch, lib, reps=10)
            bound_ms, bound_by, flops = bound(B, Sq, Sk, H, Kh, hd, causal,
                                              window, dtype_name,
                                              q.element_size())
            rec = dict(phase="kernel_vs_plain", shape=name,
                       dims=[B, Sq, Sk, H, Kh, hd], causal=causal,
                       window=window, dtype=dtype_name,
                       max_abs_err_o=err_o, max_abs_err_lse=err_l,
                       tol=tol, kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by,
                       kernel_tflops=flops / kernel_ms / 1e9)
            emit(**rec)
            records[(name, dtype_name)] = rec
            del q, k, v, out, lse
            torch.cuda.empty_cache()
    return records[("granite_prefill", "bfloat16")]


def prefill_batch(torch, prompts, S):
    """Right-padded (len(prompts), S) token batch and its lengths, on the
    card."""
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    return ({"tokens": torch.from_numpy(toks).cuda()},
            torch.from_numpy(lens).cuda())


def serve_full_width(torch, get_config, init_params, ServeEngine, Request,
                     prefill, fa_kernel):
    """Phase 3: full-width granite-3-2b through the engine.  Returns the
    kernel launches counted over the engine's run, the params and the
    prompts."""
    cfg = get_config("granite-3-2b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    _map(params, lambda t: sizes.append(t.numel()))
    n_params = sum(sizes)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{cfg.param_count()}")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n))
               for n in rng.integers(16, 1501, size=16)]

    # warm-up: cuBLAS handles and allocator pools, outside the timed run
    warm = ServeEngine(cfg, params, slots=8, cache_len=2048, device="cuda")
    warm.submit(Request(rid=-1, prompt=prompts[0][:16], max_tokens=2))
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    engine = ServeEngine(cfg, params, slots=8, cache_len=2048,
                         device="cuda")
    reqs = [Request(rid=i, prompt=p, max_tokens=32)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa_kernel.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa_kernel.launches

    s = engine.stats()
    if len(done) != 16 or any(len(r.generated) != 32 for r in reqs):
        raise AssertionError(f"not every request completed with 32 tokens: "
                             f"{[len(r.generated) for r in reqs]}")
    if (launches != cfg.n_layers * s["prefill_calls"] or launches == 0
            or s["flash_attention_launches"] != launches):
        raise AssertionError(f"flash-attention launches {launches} != "
                             f"{cfg.n_layers} x {s['prefill_calls']} "
                             f"prefill calls")
    tokens = sum(len(r.generated) for r in reqs)
    emit(phase="serve_full_width", arch=cfg.name, params=n_params,
         init_s=init_s, requests=len(done), tokens=tokens, wall_s=wall,
         tokens_per_s=tokens / wall,
         prompt_tokens=int(sum(len(p) for p in prompts)),
         prefill_calls=s["prefill_calls"], decode_steps=s["decode_steps"],
         flash_attention_launches=launches,
         ttft_p50_s=s["ttft_p50_s"], ttft_p99_s=s["ttft_p99_s"],
         tpot_p50_s=s["tpot_p50_s"], tpot_p99_s=s["tpot_p99_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # one prefill batch through the kernel and through plain attention,
    # both in bf16, each held against the plain path in f32
    B, S = 8, 2048
    batch, lens_d = prefill_batch(torch, prompts[:B], S)
    logits, times = {}, {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg, attention_backend=backend)
        run = lambda: prefill(params, c, batch, 2048,  # noqa: E731
                              lengths=lens_d)
        times[backend] = cuda_ms(torch, run, reps=2)
        logits[backend] = run()[0].float()
        torch.cuda.empty_cache()
    p32 = _map(params, lambda t: t.float())
    c32 = dataclasses.replace(cfg, attention_backend="torch",
                              param_dtype="float32")
    ref = prefill(p32, c32, batch, 2048, lengths=lens_d)[0]
    del p32
    torch.cuda.empty_cache()

    def rel(x, y):
        return ((x - y).norm() / y.norm()).item()
    a, b = logits["cuda"], logits["torch"]
    rel_cuda, rel_torch = rel(a, ref), rel(b, ref)
    max_abs = (a - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1)
    margin = top2.values[:, 0] - top2.values[:, 1]
    arg_ref = top2.indices[:, 0]
    # a differing argmax is a fault only where the f32 top-2 margin
    # exceeds twice the kernel path's largest logit error
    faults = ((a.argmax(-1) != arg_ref) & (margin > 2 * max_abs)).sum().item()
    emit(phase="prefill_cuda_vs_torch", batch=[B, S],
         prefill_ms_cuda=times["cuda"], prefill_ms_torch=times["torch"],
         rel_err_cuda_bf16_vs_f32=rel_cuda,
         rel_err_torch_bf16_vs_f32=rel_torch,
         rel_err_cuda_vs_torch=rel(a, b), max_abs_err_cuda_vs_f32=max_abs,
         argmax_agree_cuda_f32=int((a.argmax(-1) == arg_ref).sum().item()),
         argmax_agree_torch_f32=int((b.argmax(-1) == arg_ref).sum().item()),
         rows=B, argmax_faults=faults)
    # the kernel path may be no more than twice as far from f32 as the
    # plain bf16 path (it rounds P to bf16 before P V, as the TPU kernel)
    if rel_cuda > 2 * rel_torch or faults:
        raise AssertionError(f"prefill through the kernel strays from f32: "
                             f"rel {rel_cuda} vs plain {rel_torch}, "
                             f"faults {faults}")
    return launches, params, prompts


def profile_steps(torch, cfg, params, prompts, prefill, decode_step):
    """Phase 3b: device time by operation over one (8, 2048) prefill and
    8 decode steps, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, S = 8, 2048
    batch, lens_d = prefill_batch(torch, prompts[:B], S)
    out = {}
    for name, steps in (("prefill", 1), ("decode", 8)):
        logits, state = prefill(params, cfg, batch, 2048, lengths=lens_d)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        pos = lens_d.clone()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                if name == "prefill":
                    prefill(params, cfg, batch, 2048, lengths=lens_d)
                else:
                    logits, state = decode_step(params, cfg, state, tok, pos)
                    tok = logits.argmax(-1).to(torch.int32)[:, None]
                    pos = pos + 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, memcpys): the aten ops that
        # launch them report the same device time again
        rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        out[name] = busy_ms
        emit(phase="profile", what=name, steps=steps, wall_ms=wall_ms,
             device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
             top=[{"op": k[:60], "ms": ms, "calls": n}
                  for ms, k, n in rows[:8]])
        del state
        torch.cuda.empty_cache()
    if not all(out.values()):
        raise AssertionError(f"the profiler saw no device time: {out}")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.serve import serve_main
    from repro_torch.models import init_params
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serve import Request, ServeEngine

    # f32 products in the plain versions stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    fa.library()
    emit(phase="build", kernel="flash_attention_fwd", source=KERNEL_SOURCE,
         seconds=time.perf_counter() - t0)

    k1 = kernel_vs_plain(torch, F, fa.flash_attention_fwd_kernel,
                         attention_ref)
    launches, params, prompts = serve_full_width(
        torch, get_config, init_params, ServeEngine, Request, prefill,
        fa.flash_attention_fwd_kernel)
    profile_steps(torch, get_config("granite-3-2b"), params, prompts,
                  prefill, decode_step)
    del params
    torch.cuda.empty_cache()

    fa.flash_attention_fwd_kernel.launches = 0
    cli = serve_main("granite-3-2b")
    cli_launches = fa.flash_attention_fwd_kernel.launches
    n_layers = get_reduced("granite-3-2b").n_layers
    if cli["requests"] != 16 or cli_launches != n_layers * cli[
            "prefill_calls"] or cli_launches == 0:
        raise AssertionError(f"serve_main: {cli}, launches {cli_launches}")
    emit(phase="serve_main_reduced", launches=cli_launches, **cli)

    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": k1["max_abs_err_o"],
        "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

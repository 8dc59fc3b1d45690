#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. print the card's name and power limit; build the kernels from
   ``src/repro_torch/.../csrc`` with nvcc (sm_90a), one nvcc per source,
   started together: the flash-attention forward (K1) and backward (K2
   dQ, K3 dK/dV), the SSD chunk scan (K4) and the percentile stretch (K5);
2. hold K1 against its plain PyTorch version on the card, in bf16 and f32,
   at the prefill shapes of granite-3-2b, glm4-9b (GQA 16 at hd 128),
   codeqwen1.5-7b (MHA at hd 128) and qwen3-moe-30b-a3b (GQA 8 at hd 128,
   a window of 8192 that binds nowhere at 2048) and at ragged, windowed
   and MHA hd=128 shapes (one JSON line per shape: K1's route, tensor
   cores for bf16 at hd 64 and 128, CUDA cores otherwise, checked by its
   route counter;
   errors, kernel / plain / library ms, the wrapper's host ms per call,
   TFLOP/s, the least time the card could take and the kernel's share of
   it);
3. hold K2 and K3 against the plain backward, in bf16 and f32, at
   stablelm-1.6b's training shape, granite-3-2b's GQA shape and ragged,
   windowed and MHA hd=128 shapes, the same way (their route, by the same
   table as K1's, checked by their route counters; each kernel's share of
   its bound and the wrapper's host ms per call); then the whole
   differentiable op (K1 -> K2 + K3) against autograd of plain attention;
4. train full-width stablelm-1.6b (24 layers, bf16, random weights from a
   seed) through ``TrainLoop``: AdamW, warmup-cosine, remat, the Markov
   token stream at batch 8 x seq 2048; K1 must launch 2 x 24 times a
   step and K2 and K3 24, every launch on the tensor cores; losses,
   steps/s, tokens/s, model FLOP utilisation and peak memory;
   ``torch.profiler`` over one step; then one (4, 2048) step's loss and
   gradients through the kernels and through plain attention, both bf16,
   each against plain attention in f32;
5. serve full-width granite-3-2b (40 layers, bf16, random weights from a
   seed) through ``ServeEngine``: 16 greedy requests, prompts of 16-1500
   tokens, 32 new tokens each, 8 slots; K1 must launch 40 x prefill calls,
   every launch on the tensor cores;
   one prefill batch through the kernel and through plain attention, each
   held against an f32 prefill; ``torch.profiler`` over one prefill and 8
   decode steps;
5c. the same for glm4-9b (40 layers, 32 q / 2 kv heads of 128) and
   codeqwen1.5-7b (32 layers, 32 heads of 128), whose logit gate runs at 4
   rows (``GATE_ROWS``);
5d. serve full-width granite-3-2b through ``ServeScheduler`` on the real
   clock: 32 requests of a Poisson trace at 2 requests/s, a 5 s TTFT SLO
   and a KV pool of 384 blocks of 16, so that requests are evicted and
   re-prefilled; every request completes or is shed, every block returns,
   K1 launches 40 x prefill calls on the tensor cores; tokens/s, goodput,
   TTFT / TPOT / queue-wait percentiles; ``torch.profiler`` over 8 of the
   scheduler's decode ticks;
5e. token identity: (a) 16 of those prompts arriving at once through the
   scheduler and through the engine at full width give the same greedy
   tokens (and, not gated, how phase 5d's evicted requests compare with
   the same prompts served unevicted); (b)
   the reduced granite in f32 on the card resumes evicted requests token
   for token;
6. run ``serve_main("granite-3-2b")`` (the reduced serve CLI) on the card,
   then (6b) its continuous mode for granite-3-2b and mamba2-2.7b;
5f. serve full-width qwen3-moe-30b-a3b (48 layers, 128 experts top-8,
   bf16, random weights from a seed) through ``ServeEngine`` with phase
   5's traffic: the parameters equal ``param_count()``, K1 launches 48 x
   prefill calls, every launch on the tensor cores; ``torch.profiler``
   over one prefill and 8 decode steps; the MoE layer's time by stage
   (routing, dispatch, the experts' matmuls, combine) at the prefill's
   and a decode step's tokens; then the logit gate on a 4-layer depth cut
   of the same widths (``GATE_LAYERS``: the full depth's f32 yardstick
   would take 122 GB), after the full model is freed, with its routing
   witness (the share of tokens whose experts differ from f32's, and the
   error left when the f32 prefill takes the kernel path's experts);
7. run ``train_main("stablelm-1.6b")`` (the reduced train CLI) with
   checkpoints, preempt it, resume it, and hold it bitwise against an
   uninterrupted run, in PyTorch's deterministic mode: in f32 (7, the
   CUDA-core route of K1-K3) and in ``precision="bf16"`` (7b: q/k/v in
   bf16 at hd 64, so every K1, K2 and K3 launch must take the tensor
   cores);
8. hold K4 against the plain chunked scan: y and the final state, in bf16
   and f32 at mamba2-2.7b's serving prefill shape (Bs 8, S 2048, 80 heads
   of 64, g 1, N 128, Q 256), and in bf16 at a ragged S 1000, jamba's
   widths (128 heads of 128, g 8), the one-period jamba's prefill (Bs 8,
   S 2048, 64 heads of 128, g 8) and its ragged S 1000, and Q 64 at
   S 4096; each shape's route
   (tensor cores for bf16, CUDA cores for f32, checked by the route
   counters) and two launches bitwise equal; ptxas's registers and spills
   of the tensor-core entries (a second nvcc, ``-Xptxas -v``, in phase 1);
9. serve full-width mamba2-2.7b (64 layers, bf16, random weights from a
   seed) through ``ServeEngine`` with phase 5's traffic; K4 must launch
   64 x prefill calls, every launch on the tensor cores; the prefill batch
   through K4 and through the plain scan, each against an f32 prefill;
   ``torch.profiler`` over one prefill and 8 decode steps; then
   ``serve_main("mamba2-2.7b")`` and its K4 routes;
9c. the hybrid: jamba-1.5-large-398b cut to one period
   (``jamba_one_period``: 8 layers, 7 SSD and 1 attention, MoE on 4;
   d_model 4096) through ``ServeEngine`` with phase 5's traffic: K1
   launches 1 and K4 7 x prefill calls, all on the tensor cores; the
   prefill through the kernels and through the plain versions against
   f32, with the routing witness of 5f; then
   ``serve_main("jamba-1.5-large-398b")`` (reduced, f32, the
   CUDA-core routes);
9d. train full-width mamba2-2.7b through ``TrainLoop`` (AdamW,
   warmup-cosine, remat) at batch 8 x seq 2048, a warm-up and 3 measured
   steps: K4 launches twice per layer and step (the forward and remat's
   recompute; its backward is the plain scan), all on the tensor cores;
   ``torch.profiler`` over one step; what one layer's plain backward
   adds to the memory; one (4, 2048) step's loss and gradients through
   K4 and through the plain scan against f32;
10. hold K5 against the plain stretch, bit for bit, on reflectance-like
    data made on the card: a 10980 x 10980 Sentinel-2 tile of 4 and of 13
    bands, more than 2**31 elements (checked in row chunks), the vision
    slice's scene and composite, a ragged R and one band, and bf16 input;
    at the 4-band tile also the time of the percentile helper (its sort);
11. the burned-area study: ``build_dataset`` normalizes four 2048 x 2048
    scenes through K5 (4 launches) and chips them at the paper's recipe;
    the scenes are held against numpy's ``percentile_stretch`` and the
    plain stretch on the card; U-Net at width 16 trains 4 epochs (Adam,
    batch 16), then U-Net++, DeepLabV3 and DeepLabV3+ one epoch each
    (LAMB); losses, steps/s, chips/s, peak memory, val metrics;
    ``torch.profiler`` over one U-Net step; each model's and ChangeFormer's
    forward on the card against the same weights on the CPU;
12. the deforestation study: ``build_pairs`` makes six 256 x 256 NIR-R-G
    composite pairs through K5 (12 launches), held against numpy's
    ``nir_rg``; ChangeFormer trains 60 full-batch AdamW steps on four and
    is scored on two;
13. the reduced vision CLI (``repro_torch.launch.vision.main``) on the
    card.
14. (run between phases 9d and 10) the run API's front door in this
    process:
    ``repro_torch.launch.__main__.main(["run", "train", "--full", ...])``
    trains full-width stablelm-1.6b (bf16, 8 x 2048, 4 steps): a
    ``succeeded`` report, 4 finite losses, K1-K3 launched as
    ``train_launches`` predicts, all on the tensor cores; steps/s, the
    loop's step time, the report's ``wall_s`` and the peak memory;
15. ``python -m repro_torch.launch run serve`` as real subprocesses:
    granite-3-2b (the same counts as a direct ``serve_main`` call, K1
    launched) and mamba2-2.7b (K4 launched); ``run bogus`` exits 2;
16. ``run train`` on the reduced stablelm (bf16, deterministic mode)
    preempted (a ``failed`` report), then ``--resume``: losses and final
    checkpoint bitwise equal to an uninterrupted ``train_main`` call's;
17. a two-learning-rate grid of the reduced stablelm through
    ``Orchestrator.submit_runs(attach_payload=True)`` and ``run_local``:
    each job preempted once, resumed from step 2 under the retry env,
    results on the PVC and in S3 with the checkpoints, every K1-K3 launch
    on the tensor cores;
18. ``run simulate --campaign all``: 234 jobs, 234 manifests, 4040.0
    wall-hours; ``autobatch`` for stablelm-1.6b at seq 2048 against the
    card's own ``MemoryBudget`` (not gated).

The line before the last lists each ported kernel with its launches on
its main path (K1-K3 training, and K1 on each serving path, qwen3-moe's
and the hybrid's included; K4 mamba2 serving, with the hybrid's and
mamba2 training's beside it; K5 the two vision studies; K1-K3's launches
in phases 14, 16 and 17 as ``launches_run_api``, and the subprocesses'
K1 and K4 launches of phase 15 as ``launches_run_api_cli``), K1-K4's route
(``core_route``) and its numbers at the training shape (K2, K3),
granite's prefill shape (K1, with glm4's, codeqwen's and qwen3's beside
it), mamba2's prefill shape (K4) or the 4-band Sentinel-2 tile (K5); the
last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA card, or without the repository beside
it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

T_START = time.perf_counter()     # each emitted line's t_s counts from here
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CSRC = "src/repro_torch/kernels/flash_attention/csrc/"
TPU_KERNELS = "src/repro/kernels/flash_attention/kernel.py"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_attention_fwd": (CSRC + "flash_fwd.cu", TPU_KERNELS + ":57"),
    "flash_attention_bwd_dq": (CSRC + "flash_bwd.cu", TPU_KERNELS + ":148"),
    "flash_attention_bwd_dkv": (CSRC + "flash_bwd.cu", TPU_KERNELS + ":179"),
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:24"),
    "percentile_norm": (
        "src/repro_torch/kernels/percentile_norm/csrc/percentile_norm.cu",
        "src/repro/kernels/percentile_norm/kernel.py:22"),
}

# H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# name, B, Sq, Sk, H, Kh, hd, causal, window
SHAPES = [
    ("granite_prefill", 8, 2048, 2048, 32, 8, 64, True, None),
    ("ragged_s1000", 2, 1000, 1000, 32, 8, 64, True, None),
    ("window_512", 2, 2048, 2048, 32, 8, 64, True, 512),
    ("mha_hd128", 2, 1024, 1024, 16, 16, 128, True, None),
    ("glm4_prefill", 8, 2048, 2048, 32, 2, 128, True, None),
    ("codeqwen_prefill", 8, 2048, 2048, 32, 32, 128, True, None),
    ("qwen3_prefill", 8, 2048, 2048, 32, 4, 128, True, 8192),
]
# kernel vs plain in the working dtype: f32 differs only by summation
# order; bf16 adds the output's rounding to bf16 (~4e-3 relative)
TOL = {"float32": {"o": 2e-5, "lse": 1e-4},
       "bfloat16": {"o": 2e-2, "lse": 1e-4}}
# name, B, Sq, Sk, H, Kh, hd, causal, window
BWD_SHAPES = [
    ("stablelm_train", 8, 2048, 2048, 32, 32, 64, True, None),
    ("granite_gqa", 8, 2048, 2048, 32, 8, 64, True, None),
    ("ragged_s1000", 2, 1000, 1000, 32, 8, 64, True, None),
    ("window_512", 2, 2048, 2048, 32, 8, 64, True, 512),
    ("mha_hd128", 2, 1024, 1024, 16, 16, 128, True, None),
]
# K2/K3 against the plain backward: both compute in f32 from the same
# inputs and return f32, so only the order of the f32 sums differs
BWD_TOL = 2e-4
# the whole op against autograd of plain attention: in bf16 the forward
# rounds P to bf16 before P V and the gradients are rounded to bf16
FN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
TRAIN_STEPS, TRAIN_B, TRAIN_S = 8, 8, 2048
# mamba2-2.7b's measured training steps (phase 9d), after one warm-up
MAMBA_TRAIN_STEPS = 3
# name, Bs, S, nh, hp, g, N, Q, dtypes
SSD_SHAPES = [
    ("mamba2_prefill", 8, 2048, 80, 64, 1, 128, 256,
     ("bfloat16", "float32")),
    ("ragged_s1000", 2, 1000, 80, 64, 1, 128, 256, ("bfloat16",)),
    ("jamba_widths", 1, 1024, 128, 128, 8, 128, 256, ("bfloat16",)),
    # the one-period jamba's prefill (phase 9c): its batch and its 64 heads
    ("jamba_cut_prefill", 8, 2048, 64, 128, 8, 128, 256, ("bfloat16",)),
    ("jamba_cut_ragged_s1000", 2, 1000, 64, 128, 8, 128, 256,
     ("bfloat16",)),
    ("chunk64_s4096", 1, 4096, 80, 64, 1, 128, 64, ("bfloat16",)),
]
# K4 against the plain chunked scan, (atol, rtol).  Both compute in f32
# from the same inputs and differ by summation order, an error that scales
# with the size of the partial sums: atol is 3e-5 of the plain version's
# largest |value| (f32's 6e-8 over the ~400 terms of a row: 256 intra,
# 128 inter), rtol 1e-4.  A bf16 y is also rounded to bf16 (one ulp =
# 2**-8 relative): 2e-2 as for K1.  h_final is f32 in both.
SSD_TOL = {"float32": {"y": ("scaled", 3e-5, 1e-4),
                       "h": ("scaled", 3e-5, 1e-4)},
           "bfloat16": {"y": ("fixed", 2e-2, 2e-2),
                        "h": ("scaled", 3e-5, 1e-4)}}
S2_TILE = 10980 * 10980   # pixels of one Sentinel-2 L2A tile at 10 m
# name, R, C, dtype
PN_SHAPES = [
    ("s2_tile_4band", S2_TILE, 4, "float32"),
    ("s2_tile_13band", S2_TILE, 13, "float32"),
    ("over_2p31", 2 ** 29 + 1, 4, "float32"),
    ("ba_scene", 2048 * 2048, 4, "float32"),
    ("defo_composite", 256 * 256, 3, "float32"),
    ("ragged_r1000", 1000, 13, "float32"),
    ("one_band", 1000, 1, "float32"),
    ("s2_tile_4band_bf16", S2_TILE, 4, "bfloat16"),
]
# K5 against the plain stretch: the same f32 operations in the same order,
# so equal bit for bit; one f32 ulp at 1.0 is the most allowed
PN_TOL = 1.2e-7
# rows of the >2**31-element case compared (and timed plainly) at a time
PN_CHUNK = 2 ** 26
# the vision slice at full width (paper recipe: 256 chips, overlap 0.25,
# both classes at least 10%): parameters of each model at width 16 (the
# JAX package's counts) and the chips four 2048 x 2048 scenes give
SEG_PARAMS = {"unet": 487314, "unetpp": 558866, "deeplabv3": 474194,
              "deeplabv3plus": 557794, "changeformer": 324258}
BA_CHIPS = {"train": 87, "val": 19, "test": 0}
# a model's forward on the card against the CPU on the same weights, f32
# with TF32 off in both: summation order only
FWD_TOL = 1e-4


def _ssd_close(torch, got, want, tol):
    """assert_close under one SSD_TOL entry; returns the atol used."""
    kind, a, r = tol
    atol = a * want.abs().max().item() if kind == "scaled" else a
    torch.testing.assert_close(got, want, atol=atol, rtol=r)
    return atol


def emit(**rec):
    print(json.dumps({**rec, "t_s": time.perf_counter() - T_START}),
          flush=True)


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


def least_ms(flops: float, nbytes: float, dtype: str):
    """The larger of operations over the dtype's peak and bytes over HBM
    bandwidth, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound(B, Sq, Sk, H, Kh, hd, causal, window, dtype: str, esize: int):
    """Least time (ms) for the forward: operations (QK^T and PV, 2 flops
    per multiply-add each) over the dtype's peak, or bytes (q, k, v read
    once, o and the f32 LSE written once) over HBM bandwidth."""
    flops = 4 * hd * valid_pairs(Sq, Sk, causal, window) * B * H
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * Kh * hd) * esize \
        + 4 * B * H * Sq
    return (*least_ms(flops, nbytes, dtype), flops)


def bwd_bounds(B, Sq, Sk, H, Kh, hd, causal, window, dtype: str,
               esize: int) -> dict:
    """Least times (ms) of the backward kernels.  Operations per admitted
    (q, k) pair: K2 6*hd (S = QK^T, dP = dO V^T, dS K), K3 8*hd (S, dP,
    P^T dO, dS^T Q), a fused single pass 10*hd (S and dP once).  Bytes:
    q, k, v, dO read once, the f32 LSE and D read once, the f32 outputs
    written once."""
    pairs = valid_pairs(Sq, Sk, causal, window) * B * H
    reads = (2 * B * Sq * H * hd + 2 * B * Sk * Kh * hd) * esize \
        + 2 * 4 * B * H * Sq
    dq_bytes, dkv_bytes = 4 * B * Sq * H * hd, 2 * 4 * B * Sk * Kh * hd
    out = {}
    for name, per_pair, nbytes in (
            ("dq", 6, reads + dq_bytes), ("dkv", 8, reads + dkv_bytes),
            ("fused", 10, reads + dq_bytes + dkv_bytes)):
        ms, by = least_ms(per_pair * hd * pairs, nbytes, dtype)
        out[name] = {"ms": ms, "by": by, "flops": per_pair * hd * pairs}
    return out


def ssd_bound(Bs, S, nh, hp, g, N, Q, dtype: str, esize: int):
    """Least time (ms) of the SSD scan.  Operations per (batch, chunk of Qc
    rows): 2 Qc(Qc+1)/2 N per group for C B^T, and per head 2 Qc(Qc+1)/2 hp
    (intra), 2 Qc N hp (inter) and 2 Qc N hp (state update); the peak is the
    inputs' dtype's.  Bytes: x, dt, A, B and C read once, y and the f32
    h_final written once."""
    chunks = [min(Q, S - c0) for c0 in range(0, S, Q)]
    flops = Bs * sum(g * qc * (qc + 1) * N
                     + nh * (qc * (qc + 1) * hp + 4 * qc * N * hp)
                     for qc in chunks)
    nbytes = (2 * Bs * S * nh * hp * esize + 4 * Bs * S * nh + 4 * nh
              + 2 * Bs * S * g * N * esize + 4 * Bs * nh * hp * N)
    return (*least_ms(flops, nbytes, dtype), flops, nbytes)


def ssd_vs_plain(torch, ssd, ssd_chunked_ref):
    """Phase 8: K4 against the plain chunked scan.  x, B and C are strided
    views of one buffer, as the mixer hands them over.  Each shape runs on
    its route (bf16 on the tensor cores, f32 on the CUDA cores), checked by
    the route counters, and two launches must be bitwise equal.  Returns
    the serving-shape bf16 record."""
    kernel = ssd.ssd_scan_kernel
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, Bs, S, nh, hp, g, N, Q, dtypes in SSD_SHAPES:
        for dtype_name in dtypes:
            dtype = getattr(torch, dtype_name)
            buf = torch.randn((Bs, S, nh * hp + 2 * g * N), generator=gen,
                              device="cuda").to(dtype)
            x = buf[..., :nh * hp].reshape(Bs, S, nh, hp)
            B = buf[..., nh * hp:nh * hp + g * N].reshape(Bs, S, g, N)
            C = buf[..., nh * hp + g * N:].reshape(Bs, S, g, N)
            dt = torch.nn.functional.softplus(torch.randn(
                (Bs, S, nh), generator=gen, device="cuda"))
            A = -torch.exp(0.3 * torch.randn(nh, generator=gen,
                                             device="cuda"))
            route = ssd.route(dtype, hp, N)
            want = ("tensor_core" if dtype_name == "bfloat16"
                    else "cuda_core")
            before = dict(kernel.launches_by_route)
            y, h = kernel(x, dt, A, B, C, chunk=Q)
            y2, h2 = kernel(x, dt, A, B, C, chunk=Q)
            torch.cuda.synchronize()
            took = {k: v - before[k]
                    for k, v in kernel.launches_by_route.items()}
            if route != want or took != {r: 2 * (r == want)
                                         for r in ssd.ROUTES}:
                raise AssertionError(f"K4 {name} {dtype_name}: route "
                                     f"{route}, launches {took}; want "
                                     f"{want}")
            bitwise = bool(torch.equal(y, y2) and torch.equal(h, h2))
            if not bitwise:
                raise AssertionError(f"K4 {name} {dtype_name}: two launches "
                                     f"differ")
            del y2, h2
            yr, hr = ssd_chunked_ref(x, dt, A, B, C, Q)
            err_y = (y.float() - yr.float()).abs().max().item()
            err_h = (h - hr).abs().max().item()
            tol = SSD_TOL[dtype_name]
            atol_y = _ssd_close(torch, y.float(), yr.float(), tol["y"])
            atol_h = _ssd_close(torch, h, hr, tol["h"])
            max_y, max_h = (yr.float().abs().max().item(),
                            hr.abs().max().item())
            del yr, hr
            torch.cuda.empty_cache()
            kernel_ms = cuda_ms(torch, lambda: kernel(
                x, dt, A, B, C, chunk=Q), reps=10)
            plain_ms = cuda_ms(torch, lambda: ssd_chunked_ref(
                x, dt, A, B, C, Q), reps=2)
            bound_ms, bound_by, flops, nbytes = ssd_bound(
                Bs, S, nh, hp, g, N, Q, dtype_name, x.element_size())
            rec = dict(phase="ssd_kernel_vs_plain", shape=name,
                       dims=[Bs, S, nh, hp, g, N, Q], dtype=dtype_name,
                       route=route, bitwise_repeat=bitwise,
                       max_abs_err_y=err_y, max_abs_err_h=err_h, tol=tol,
                       atol_y=atol_y, atol_h=atol_h, max_abs_y=max_y,
                       max_abs_h=max_h,
                       kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                       flops=flops, bytes=nbytes,
                       kernel_tflops=flops / kernel_ms / 1e9)
            emit(**rec)
            records[(name, dtype_name)] = rec
            del buf, x, B, C, dt, A, y, h
            torch.cuda.empty_cache()
    return records[("mamba2_prefill", "bfloat16")]


def ptxas_start(source: Path, out_dir: str):
    """Start nvcc on ``source`` with ``-Xptxas -v`` (the library build
    discards the compiler's output); :func:`ptxas_report` reads it."""
    from repro_torch.kernels.common import NVCC_FLAGS, _nvcc
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, "ptxas.so"), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(proc, entry: str) -> list:
    """Registers and spills ptxas reported for each entry whose name holds
    ``entry``."""
    log = proc.communicate(timeout=600)[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{log}")
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and entry in ln:
            rest = lines[i + 1:i + 5]
            out.append({"entry": ln.split("'")[1],
                        "spill": next((r.strip() for r in rest
                                       if "spill" in r), None),
                        "used": next((r.split(":", 1)[1].strip()
                                      for r in rest if "Used" in r), None)})
    return out


def kernel_vs_plain(torch, F, fa, attention_ref):
    """Phase 2.  Returns the records by (shape, dtype)."""
    fa_kernel = fa.flash_attention_fwd_kernel
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, B, Sq, Sk, H, Kh, hd, causal, window in SHAPES:
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
            q, k, v = rnd(B, Sq, H, hd), rnd(B, Sk, Kh, hd), rnd(B, Sk, Kh, hd)
            route = fa.route(dtype, hd)
            n0 = fa_kernel.launches_by_route[route]
            out, lse = fa_kernel(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            if fa_kernel.launches_by_route[route] != n0 + 1:
                raise AssertionError(f"{name} {dtype_name}: K1 did not take "
                                     f"the {route} route")
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
            # the wrapper's host time per call (checks, outputs, tensor
            # maps, launch): back-to-back calls cannot beat it
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fa_kernel(q, k, v, causal=causal, window=window)
            host_ms = (time.perf_counter() - t0) * 100
            torch.cuda.synchronize()
            plain_ms = cuda_ms(torch, lambda: attention_ref(
                q, k, v, causal=causal, window=window), reps=2)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if window is None or window >= Sk:    # the window binds nowhere
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
                       window=window, dtype=dtype_name, route=route,
                       max_abs_err_o=err_o, max_abs_err_lse=err_l,
                       tol=tol, kernel_ms=kernel_ms, host_ms=host_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       kernel_tflops=flops / kernel_ms / 1e9,
                       share_of_bound=bound_ms / kernel_ms)
            emit(**rec)
            records[(name, dtype_name)] = rec
            del q, k, v, out, lse
            torch.cuda.empty_cache()
    return records


def bwd_vs_plain(torch, F, fa, ref):
    """Phase 3: K2 and K3 against the plain backward.  Returns the
    stablelm training-shape bf16 record."""
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, B, Sq, Sk, H, Kh, hd, causal, window in BWD_SHAPES:
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
            q, k, v = rnd(B, Sq, H, hd), rnd(B, Sk, Kh, hd), rnd(B, Sk, Kh, hd)
            do = rnd(B, Sq, H, hd)
            out, lse = fa.flash_attention_fwd_kernel(q, k, v, causal=causal,
                                                     window=window)
            delta = ref.row_delta(out, do)
            mask = dict(causal=causal, window=window)
            route = fa.route(dtype, hd)
            kernels = (fa.flash_attention_bwd_dq_kernel,
                       fa.flash_attention_bwd_dkv_kernel)
            n0 = [fn.launches_by_route[route] for fn in kernels]
            got = fa.flash_attention_bwd_kernel(q, k, v, do, lse, delta,
                                                **mask)
            torch.cuda.synchronize()
            if [fn.launches_by_route[route] for fn in kernels] != [
                    n + 1 for n in n0]:
                raise AssertionError(f"{name} {dtype_name}: K2/K3 did not "
                                     f"take the {route} route")
            want = ref.attention_bwd_ref(q, k, v, out, lse, do, **mask)
            errs = {}
            for what, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[what] = (g - w).abs().max().item()
                torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)
            del got, want
            torch.cuda.empty_cache()

            dq_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_dq_kernel(
                q, k, v, do, lse, delta, **mask), reps=5)
            dkv_ms = cuda_ms(torch, lambda: fa.flash_attention_bwd_dkv_kernel(
                q, k, v, do, lse, delta, **mask), reps=5)
            # each wrapper's host time per call (checks, outputs, tensor
            # maps, launch): back-to-back calls cannot beat it
            host_ms = {}
            for what, fn in zip(("dq", "dkv"), kernels):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn(q, k, v, do, lse, delta, **mask)
                host_ms[what] = (time.perf_counter() - t0) * 100
                torch.cuda.synchronize()
            plain_ms = cuda_ms(torch, lambda: ref.attention_bwd_ref(
                q, k, v, out, lse, do, **mask), reps=1)
            torch.cuda.empty_cache()
            # the library yardstick: the backward of SDPA through autograd
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            if window is None:
                lo = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            else:
                qp = torch.arange(Sq, device="cuda")[:, None]
                kp = torch.arange(Sk, device="cuda")[None, :]
                lo = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=(kp <= qp) & (kp > qp - window),
                    enable_gqa=True)
            dot = do.transpose(1, 2)
            library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                lo, (qt, kt, vt), dot, retain_graph=True), reps=5)
            del lo, qt, kt, vt
            b = bwd_bounds(B, Sq, Sk, H, Kh, hd, causal, window, dtype_name,
                           q.element_size())
            rec = dict(phase="bwd_kernel_vs_plain", shape=name,
                       dims=[B, Sq, Sk, H, Kh, hd], causal=causal,
                       window=window, dtype=dtype_name, route=route,
                       max_abs_err=errs, tol=BWD_TOL,
                       dq_kernel_ms=dq_ms, dkv_kernel_ms=dkv_ms,
                       host_ms=host_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       dq_bound_ms=b["dq"]["ms"], dq_bound_by=b["dq"]["by"],
                       dkv_bound_ms=b["dkv"]["ms"],
                       dkv_bound_by=b["dkv"]["by"],
                       fused_bound_ms=b["fused"]["ms"],
                       dq_share_of_bound=b["dq"]["ms"] / dq_ms,
                       dkv_share_of_bound=b["dkv"]["ms"] / dkv_ms,
                       dq_tflops=b["dq"]["flops"] / dq_ms / 1e9,
                       dkv_tflops=b["dkv"]["flops"] / dkv_ms / 1e9)
            emit(**rec)
            records[(name, dtype_name)] = rec
            del q, k, v, do, out, lse, delta
            torch.cuda.empty_cache()
    return records[("stablelm_train", "bfloat16")]


def function_vs_plain(torch, flash_attention, naive_attention):
    """Phase 3b: the differentiable op (K1 -> K2 + K3) against autograd of
    plain attention, at granite's heads, B 2, S 1024."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, Kh, hd = 2, 1024, 32, 8, 64
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
        q, k, v = (x.requires_grad_(True) for x in
                   (rnd(B, S, H, hd), rnd(B, S, Kh, hd), rnd(B, S, Kh, hd)))
        do = rnd(B, S, H, hd)
        got = torch.autograd.grad(flash_attention(q, k, v, causal=True),
                                  (q, k, v), do)
        want = torch.autograd.grad(
            naive_attention(q, k, v, causal=True, window=None), (q, k, v), do)
        tol = FN_TOL[dtype_name]
        errs = {}
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[what] = (g.float() - w.float()).abs().max().item()
            torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                       rtol=tol)
        emit(phase="function_vs_plain_autograd", dims=[B, S, S, H, Kh, hd],
             dtype=dtype_name, max_abs_err=errs, tol=tol)


class _Counts:
    """The launch counters of the kernels, zeroed and read around one
    path."""

    def __init__(self, fa, ssd, pn):
        self.fns = {"flash_attention_fwd": fa.flash_attention_fwd_kernel,
                    "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_kernel,
                    "flash_attention_bwd_dkv":
                        fa.flash_attention_bwd_dkv_kernel,
                    "ssd_scan": ssd.ssd_scan_kernel,
                    "percentile_norm": pn.percentile_norm_kernel}

    FLASH = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    ROUTED = FLASH + ("ssd_scan",)

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0
        for name in self.ROUTED:
            routes = self.fns[name].launches_by_route
            for key in routes:
                routes[key] = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}

    def routes(self, names=ROUTED) -> dict:
        """Launches by route since the last zero(), of K1 to K4 or of
        ``names``."""
        return {name: dict(self.fns[name].launches_by_route)
                for name in names}


def _param_count(tree) -> int:
    sizes = []
    _map(tree, lambda t: sizes.append(t.numel()))
    return sum(sizes)


def train_launches(cfg, steps: int) -> dict:
    """Launches ``steps`` training steps make: remat runs each layer's
    forward twice (the forward pass, then the recompute in the backward),
    so K1 and K4 launch twice per layer of their kind and step; K2 and K3
    once per attention layer; K4's backward is the plain scan (the
    reference's ``_ssd_bwd``), which launches nothing."""
    kinds = cfg.layer_kinds()
    na, ns = kinds.count("attn"), kinds.count("ssm")
    return {"flash_attention_fwd": 2 * na * steps,
            "flash_attention_bwd_dq": na * steps,
            "flash_attention_bwd_dkv": na * steps,
            "ssd_scan": 2 * ns * steps, "percentile_norm": 0}


def train_full_width(torch, m, counts, arch: str = "stablelm-1.6b",
                     steps: int = TRAIN_STEPS):
    """Phases 4 (stablelm-1.6b) and 9d (mamba2-2.7b): the full-width arch
    through TrainLoop.  Returns the launches on the path, the state and
    the data stream."""
    cfg = m["get_config"](arch)
    opt = m["get_optimizer"](cfg.optimizer)
    t0 = time.perf_counter()
    state = m["init_train_state"](
        torch.Generator(device="cuda").manual_seed(0), cfg, opt,
        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(state.params)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{cfg.param_count()}")
    total = 1 + steps
    step_fn = m["make_train_step"](
        cfg, opt, lr_schedule=m["warmup_cosine"](3e-4, total,
                                                 warmup_steps=2),
        remat=True)
    data = m["LMDictBatches"](cfg.vocab, TRAIN_B, TRAIN_S, 0, "cuda")

    # one warm-up step (cuBLAS handles, allocator pools) outside the count
    warm = m["TrainLoop"](step_fn, state, data, log_every=0)
    warm.run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = m["TrainLoop"](step_fn, warm.state, data, log_every=1)
    counts.zero()
    t0 = time.perf_counter()
    res = loop.run(total)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    routes = counts.routes()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    want = train_launches(cfg, steps)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} (remat runs "
                             f"each layer's forward twice a step)")
    want_routes = {name: {"tensor_core": n, "cuda_core": 0}
                   for name, n in want.items() if name in counts.ROUTED}
    if routes != want_routes:
        raise AssertionError(f"K1-K3 routes {routes}: every training launch "
                             f"must run on the tensor cores")
    losses = loop.losses
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    tokens = TRAIN_B * TRAIN_S
    # model FLOPs: 6 N T for the weights the matmuls read (all but the
    # embedding table, which is gathered; a tied head reads it again),
    # plus attention fwd + bwd at 12 hd per admitted causal (q, k) pair
    # and head; the SSD scan is not counted
    n_mm = cfg.param_count() - cfg.vocab * cfg.d_model * (
        not cfg.tie_embeddings)
    attn = 12 * cfg.head_dim * cfg.n_heads * cfg.layer_kinds().count(
        "attn") * TRAIN_B * valid_pairs(TRAIN_S, TRAIN_S, True, None)
    flops = 6 * n_mm * tokens + attn
    step_s = wall / steps
    emit(phase="train_full_width", arch=cfg.name, params=n_params,
         init_s=init_s, batch=[TRAIN_B, TRAIN_S], steps=steps,
         losses=losses, wall_s=wall, step_s=step_s,
         steps_per_s=1 / step_s, tokens_per_s=tokens / step_s,
         model_flops_per_step=flops,
         mfu_vs_989_tflops=flops / step_s / PEAK_FLOPS["bfloat16"],
         mfu_formula="(6*N_mm*B*S + 12*hd*H*L_attn*B*S(S+1)/2) / step_s"
                     " / 989e12, N_mm = N - vocab*d (untied head) or N "
                     "(tied); SSD scan not counted",
         peak_mem_gb=peak_gb, launches=launches, routes=routes,
         pure_step_s=res["pure_step_s"])

    # phase 4b: one step under the profiler
    batch = data.next_batch()
    torch.cuda.synchronize()
    profiled = {}

    def one_step():
        profiled["state"] = step_fn(loop.state, batch)[0]
    device_profile(torch, one_step, arch=cfg.name, what="train_step",
                   steps=1)
    return launches, profiled["state"], data


def train_grads_vs_f32(torch, m, params, data, arch: str = "stablelm-1.6b"):
    """Phases 4c (stablelm-1.6b) and 9d' (mamba2-2.7b): one (4, 2048)
    step's loss and gradients through the kernels (bf16) and through
    their plain versions (bf16), each against the plain path in f32 on
    the same weights.  The leaves ``unused_leaves`` marks (an SSD layer's
    norm2 where no FFN follows) get a zero gradient; every other leaf must
    reach the loss."""
    cfg = m["get_config"](arch)
    fields = [PREFILL_KERNELS[k][1] for k in prefill_launches(cfg)]
    full = data.next_batch()
    batch = {k: v[:4] for k, v in full.items()}
    tree_leaves, tree_unflatten = m["tree_leaves"], m["tree_unflatten"]
    unused = m["unused_leaves"](params)

    def value_and_grad(p, c):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        loss = m["train_loss"](tree_unflatten(p, leaves), c, batch)
        used = iter(torch.autograd.grad(
            loss, [t for t, u in zip(leaves, unused) if not u]))
        return loss.item(), [torch.zeros_like(t) if u else next(used)
                             for t, u in zip(leaves, unused)]

    p32 = m["cast_floating"](params, torch.float32)
    c32 = dataclasses.replace(cfg, param_dtype="float32",
                              **dict.fromkeys(fields, "torch"))
    t0 = time.perf_counter()
    l32, g32 = value_and_grad(p32, c32)
    f32_s = time.perf_counter() - t0
    del p32
    den = sum(float(g.double().square().sum()) for g in g32)
    out = {}
    for backend in ("cuda", "torch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = value_and_grad(params, dataclasses.replace(
            cfg, **dict.fromkeys(fields, backend)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        num = sum(float((a.float() - b).double().square().sum())
                  for a, b in zip(g, g32))
        out[backend] = {"loss": loss, "loss_abs_err": abs(loss - l32),
                        "grad_rel_err": (num / den) ** 0.5, "step_s": secs}
        del g
        torch.cuda.empty_cache()
    del g32
    torch.cuda.empty_cache()
    emit(phase="train_grads_vs_f32", arch=cfg.name, batch=[4, TRAIN_S],
         loss_f32=l32,
         f32_step_s=f32_s, cuda_bf16=out["cuda"], torch_bf16=out["torch"])
    # a bf16 rounding of the loss (2**-9 of it) bounds the loss check
    # from below, so two tiny errors do not decide it
    c, t = out["cuda"], out["torch"]
    if (c["grad_rel_err"] > 2 * t["grad_rel_err"]
            or c["loss_abs_err"] > 2 * t["loss_abs_err"] + abs(l32) / 512):
        raise AssertionError(f"the kernel path strays from f32: {out}")


def ssd_bwd_memory(torch, m, cfg) -> dict:
    """Phase 9d'': what one SSD layer's backward adds to the memory in use
    at the training shape: K4's ``autograd.Function`` recomputes the
    forward through the plain chunked scan under autograd and
    differentiates it (the reference's ``_ssd_bwd``), so the plain scan's
    intermediates live through the backward of each layer in turn."""
    sc = cfg.ssm
    Bs, S = TRAIN_B, TRAIN_S
    nh, hp, g, N = sc.n_heads(cfg.d_model), sc.head_dim, sc.n_groups, \
        sc.d_state
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
            torch.bfloat16).requires_grad_(True)
    x, B, C = rnd(Bs, S, nh, hp), rnd(Bs, S, g, N), rnd(Bs, S, g, N)
    dt = torch.nn.functional.softplus(torch.randn(
        (Bs, S, nh), generator=gen, device="cuda")).requires_grad_(True)
    A = (-torch.exp(0.3 * torch.randn(nh, generator=gen, device="cuda"))
         ).requires_grad_(True)
    y, h = m["ssd_scan"](x, dt, A, B, C, chunk=sc.chunk, return_state=True,
                         backend="cuda")
    dy, dh = torch.randn_like(y), torch.randn_like(h)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.autograd.backward((y, h), (dy, dh))
    torch.cuda.synchronize()
    out = dict(shape=[Bs, S, nh, hp, g, N, sc.chunk],
               backward_s=time.perf_counter() - t0,
               added_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    del x, B, C, dt, A, y, h, dy, dh
    torch.cuda.empty_cache()
    return out


def train_mamba2(torch, m, counts) -> int:
    """Phase 9d: full-width mamba2-2.7b trains through TrainLoop (AdamW,
    warmup-cosine, remat) at (8, 2048): K4 launches twice per layer and
    step, every launch on the tensor cores; what the plain backward's
    recompute adds to the memory; then one (4, 2048) step's loss and
    gradients through K4 and through the plain scan against f32.  Returns
    K4's launches."""
    arch = "mamba2-2.7b"
    launches, state, data = train_full_width(torch, m, counts, arch,
                                             steps=MAMBA_TRAIN_STEPS)
    params = state.params
    del state                                    # the optimizer's moments
    torch.cuda.empty_cache()
    emit(phase="ssd_backward_memory", arch=arch,
         **ssd_bwd_memory(torch, m, m["get_config"](arch)))
    train_grads_vs_f32(torch, m, params, data, arch)
    del params, data
    torch.cuda.empty_cache()
    return launches["ssd_scan"]


def train_cli_resume(torch, m, counts, precision: str = "f32"):
    """Phases 7 (f32) and 7b (bf16): the reduced train CLI, preempted and
    resumed, bitwise against an uninterrupted run, in deterministic mode.
    The reduced stablelm has hd 64 and f32 master weights: in f32 K1-K3
    take the CUDA-core route, in bf16 (q/k/v in bf16) the tensor cores,
    and every launch must."""
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(steps=12, log_every=0, device="cuda",
                      precision=precision)
            base = m["train_main"]("stablelm-1.6b", checkpoint_dir=os.path.join(
                tmp, "oracle"), checkpoint_async=False, **kw)
            ck = os.path.join(tmp, "ck")
            counts.zero()
            try:
                m["train_main"]("stablelm-1.6b", checkpoint_dir=ck,
                                checkpoint_every=2, preempt_at_step=3, **kw)
            except m["Preemption"]:
                pass
            else:
                raise AssertionError("preempt_at_step=3 did not preempt")
            res = m["train_main"]("stablelm-1.6b", checkpoint_dir=ck,
                                  checkpoint_every=2, resume=True, **kw)
            launches = counts.read()
            routes = counts.routes(counts.FLASH)
            load, ls = m["load_checkpoint"], m["list_checkpoints"]
            got, gstep = load(ls(ck)[-1][1])
            want, wstep = load(ls(os.path.join(tmp, "oracle"))[-1][1])
            same = (set(got) == set(want) and gstep == wstep == 12 and all(
                np.array_equal(got[k], want[k]) for k in want))
            if (res["resumed_from_step"] != 2
                    or res["losses"] != base["losses"][2:] or not same):
                raise AssertionError(
                    f"{precision}: resume is not bitwise: resumed from "
                    f"{res['resumed_from_step']}, losses {res['losses']} vs "
                    f"{base['losses'][2:]}, final arrays equal: {same}")
    finally:
        torch.use_deterministic_algorithms(False)
    route = "tensor_core" if precision == "bf16" else "cuda_core"
    if any(r[route] != launches[name] or launches[name] == 0
           for name, r in routes.items()):
        raise AssertionError(f"{precision}: K1-K3 routes {routes} (launches "
                             f"{launches}): every launch must take {route}")
    emit(phase="train_main_reduced_resume", precision=precision,
         arch=res["arch"], resumed_from_step=res["resumed_from_step"],
         final_loss=res["final_loss"], losses_equal=True,
         final_checkpoint_bitwise=True, launches=launches, routes=routes,
         steps_per_s=res["steps_per_s"])


def prefill_batch(torch, prompts, S):
    """Right-padded (len(prompts), S) token batch and its lengths, on the
    card."""
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    return ({"tokens": torch.from_numpy(toks).cuda()},
            torch.from_numpy(lens).cuda())


def jamba_one_period(get_config):
    """jamba-1.5-large-398b cut to one period of 8 layers (7 SSD, 1
    attention at slot 4, MoE on the odd ones) and to d_model 4096 with 32
    q / 4 kv heads of 128 and 16 experts top-2 of ff 6144 (d_ff 6144):
    ~6.47 B parameters, ~13 GB in bf16.  The SSD shape (64 heads of 128,
    g 8, N 128, chunk 256, expand 2 over the cut d_model) and the vocab
    (65 536) are the full config's."""
    full = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(
        full, name=full.name + "-1period", n_layers=8, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=6144,
        moe=dataclasses.replace(full.moe, expert_d_ff=6144))


# prefill kernel -> (the engine's stat for it, the config field that picks
# it or its plain version, the mixer kind whose layers launch it)
PREFILL_KERNELS = {
    "flash_attention_fwd": ("flash_attention_launches", "attention_backend",
                            "attn"),
    "ssd_scan": ("ssd_scan_launches", "mixer_backend", "ssm")}
# rows of the prefill logit gate, where 8 do not fit beside the f32
# yardstick: codeqwen's f32 weights (32.8 GB) beside its bf16 ones (16.4)
# and the f32 prefill's KV caches (MHA: 17.2 GB at 8 rows, twice that
# while the layers' caches are stacked) would pass the card's 80 GB
GATE_ROWS = {"codeqwen1.5-7b": 4}
# layers of the logit gate's depth cut, where the f32 yardstick of the full
# depth does not fit: qwen3-moe's f32 weights are 122 GB.  The cut keeps
# every width and runs after the full model is freed.
GATE_LAYERS = {"qwen3-moe-30b-a3b": 4}


def prefill_launches(cfg) -> dict:
    """Launches one prefill call makes of each prefill kernel: one per
    layer of the kernel's mixer kind."""
    kinds = cfg.layer_kinds()
    return {k: kinds.count(kind) for k, (_, _, kind) in PREFILL_KERNELS.items()
            if kind in kinds}


def _check_prefill_launches(cfg, launches: dict, routes: dict,
                            prefill_calls: int, route: str, what: str,
                            stats=None):
    """Each prefill kernel launched (its layers) x prefill calls times,
    every launch on ``route``, no other kernel launched, and the engine's
    stats (``stats``) agreeing."""
    want = {k: n * prefill_calls for k, n in prefill_launches(cfg).items()}
    got = {k: v for k, v in launches.items() if v}
    bad = (got != want or prefill_calls == 0
           or any(routes[k] != {r: n * (r == route)
                                for r in ("tensor_core", "cuda_core")}
                  for k, n in want.items())
           or (stats is not None and any(
               stats[PREFILL_KERNELS[k][0]] != n for k, n in want.items())))
    if bad:
        raise AssertionError(f"{what}: launches {launches} (want {want} on "
                             f"{route} over {prefill_calls} prefill calls), "
                             f"routes {routes}")
    return want


def serve_full_width(torch, m, counts, cfg):
    """Phases 5, 5c, 5f, 9 and 9c: a full-width config through the engine.
    Returns the prefill kernels' launches over the engine's run, the
    params and the prompts."""
    ServeEngine, Request = m["ServeEngine"], m["Request"]
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = m["init_params"](
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _param_count(params)
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
    counts.zero()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    routes = counts.routes()

    s = engine.stats()
    del engine, done                     # the decode state, before the gate
    torch.cuda.empty_cache()
    if s["completed"] != 16 or any(len(r.generated) != 32 for r in reqs):
        raise AssertionError(f"not every request completed with 32 tokens: "
                             f"{[len(r.generated) for r in reqs]}")
    want = _check_prefill_launches(cfg, launches, routes, s["prefill_calls"],
                                   "tensor_core", cfg.name, stats=s)
    tokens = sum(len(r.generated) for r in reqs)
    emit(phase="serve_full_width", arch=cfg.name, params=n_params,
         init_s=init_s, mem_in_use_before_gb=mem_before / 1e9,
         requests=s["completed"], tokens=tokens, wall_s=wall,
         tokens_per_s=tokens / wall,
         prompt_tokens=int(sum(len(p) for p in prompts)),
         prefill_calls=s["prefill_calls"], decode_steps=s["decode_steps"],
         launches=launches, routes={k: routes[k] for k in want},
         ttft_p50_s=s["ttft_p50_s"], ttft_p99_s=s["ttft_p99_s"],
         tpot_p50_s=s["tpot_p50_s"], tpot_p99_s=s["tpot_p99_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return want, params, prompts


def _rel(x, y) -> float:
    return ((x - y).norm() / y.norm()).item()


def _state_rel(state, ref) -> float:
    """The relative error of a decode state (every KV cache, SSM and conv
    state, taken as one vector) against ``ref``'s, a tensor at a time."""
    num = sum((state[k].float() - ref[k].float()).square().sum().item()
              for k in ref)
    den = sum(ref[k].float().square().sum().item() for k in ref)
    return (num / den) ** 0.5


class _PickHook:
    """Patches ``moe._local_top_k`` for one run: records each MoE layer's
    (T, K) expert ids in layer order, or with ``replay`` (such a list)
    picks those experts, with the gates this run's router gives them."""

    def __init__(self, MOE, replay=None):
        self.MOE, self.replay, self.picks = MOE, replay, []

    def __enter__(self):
        self.orig = self.MOE._local_top_k

        def top_k(x, k):
            if self.replay is None:
                v, i = self.orig(x, k)
            else:
                i = self.replay[len(self.picks)]
                v = x.gather(-1, i)
            self.picks.append(i)
            return v, i
        self.MOE._local_top_k = top_k
        return self

    def __exit__(self, *exc):
        self.MOE._local_top_k = self.orig


def routing_witness(torch, m, cfg, prefill, p32, c32, batch, lens_d,
                    picks: dict, logits, state, ref, ref_st):
    """Phases 5f'' and 9c'': how much of the bf16 kernel path's distance
    from f32 the MoE's routing makes.  Per MoE layer, the share of real
    tokens whose top-k experts (as a set) differ between the kernel path
    and f32; then the f32 prefill once more with the kernel path's experts
    (the gates its own router gives them), and the kernel path's logits
    and state against that and against f32's own routing."""
    with _PickHook(m["moe"], replay=picks["cuda"]):
        same, same_st = prefill(p32, c32, batch, 2048, lengths=lens_d)
    S = batch["tokens"].shape[1]
    real = (torch.arange(S, device="cuda")[None, :]
            < lens_d[:, None]).reshape(-1)
    flips = [(((a.sort(-1).values != b.sort(-1).values).any(-1) & real)
              .sum() / real.sum()).item()
             for a, b in zip(picks["cuda"], picks["f32"])]
    rec = dict(phase="moe_routing_witness", arch=cfg.name,
               layers=cfg.n_layers, moe_layers=len(flips),
               token_flip_share_by_moe_layer=flips,
               rel_err_cuda_bf16_vs_f32=_rel(logits, ref),
               rel_err_cuda_bf16_vs_f32_same_experts=_rel(logits, same),
               rel_err_f32_same_experts_vs_f32=_rel(same, ref),
               state_rel_err_cuda_bf16_vs_f32=_state_rel(state, ref_st),
               state_rel_err_cuda_bf16_vs_f32_same_experts=_state_rel(
                   state, same_st))
    emit(**rec)
    return rec


def prefill_gate(torch, m, cfg, params, prompts, rows: int):
    """One (rows, 2048) prefill batch through the kernels and through their
    plain versions, both in bf16, each held against the plain path in f32
    on the same weights.  The kernel path may be no more than twice as far
    from f32 as the plain bf16 path (K1 rounds P to bf16 before P V, as
    the TPU kernel).  Without MoE that is judged on the last-token logits.
    With MoE it is judged on the decode state the prefill writes (every
    layer's KV cache and SSM state at every real position): a bf16
    rounding flips a near-tied top-k choice now and then, in either path,
    and over a few last tokens such flips decide the logits' error by
    chance, where over every position of every layer they average out.
    The logits' errors are reported either way, and with MoE the
    routing witness (:func:`routing_witness`)."""
    prefill = m["prefill"]
    fields = [PREFILL_KERNELS[k][1] for k in prefill_launches(cfg)]
    judged = "state" if cfg.moe is not None else "logits"
    B, S = rows, 2048
    torch.cuda.reset_peak_memory_stats()
    batch, lens_d = prefill_batch(torch, prompts[:B], S)
    logits, states, times, picks = {}, {}, {}, {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg, **dict.fromkeys(fields, backend))
        run = lambda: prefill(params, c, batch, 2048,  # noqa: E731
                              lengths=lens_d)
        times[backend] = cuda_ms(torch, run, reps=2)
        with _PickHook(m["moe"]) as hook:
            out, st = run()
        picks[backend] = hook.picks
        logits[backend] = out.float()
        if judged == "state":
            states[backend] = st
        del out, st
        torch.cuda.empty_cache()
    p32 = _map(params, lambda t: t.float())
    c32 = dataclasses.replace(cfg, param_dtype="float32",
                              **dict.fromkeys(fields, "torch"))
    with _PickHook(m["moe"]) as hook:
        ref, ref_st = prefill(p32, c32, batch, 2048, lengths=lens_d)
    picks["f32"] = hook.picks
    if judged == "state":
        routing_witness(torch, m, cfg, prefill, p32, c32, batch, lens_d,
                        picks, logits["cuda"], states["cuda"], ref, ref_st)
    del p32, picks
    st_rel = {b: _state_rel(st, ref_st) for b, st in states.items()}
    del ref_st, states
    torch.cuda.empty_cache()

    a, b = logits["cuda"], logits["torch"]
    rel_cuda, rel_torch = _rel(a, ref), _rel(b, ref)
    max_abs = (a - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1)
    margin = top2.values[:, 0] - top2.values[:, 1]
    arg_ref = top2.indices[:, 0]
    # a differing argmax is a fault only where the f32 top-2 margin
    # exceeds twice the kernel path's largest logit error
    faults = ((a.argmax(-1) != arg_ref) & (margin > 2 * max_abs)).sum().item()
    emit(phase="prefill_cuda_vs_torch", arch=cfg.name, layers=cfg.n_layers,
         batch=[B, S], kernels=sorted(prefill_launches(cfg)),
         prefill_ms_cuda=times["cuda"], prefill_ms_torch=times["torch"],
         rel_err_cuda_bf16_vs_f32=rel_cuda,
         rel_err_torch_bf16_vs_f32=rel_torch,
         rel_err_cuda_vs_torch=_rel(a, b), max_abs_err_cuda_vs_f32=max_abs,
         state_rel_err_cuda_bf16_vs_f32=st_rel.get("cuda"),
         state_rel_err_torch_bf16_vs_f32=st_rel.get("torch"),
         argmax_agree_cuda_f32=int((a.argmax(-1) == arg_ref).sum().item()),
         argmax_agree_torch_f32=int((b.argmax(-1) == arg_ref).sum().item()),
         rows=B, argmax_faults=faults, judged_on=judged,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    ours, plain = ((st_rel["cuda"], st_rel["torch"]) if judged == "state"
                   else (rel_cuda, rel_torch))
    if ours > 2 * plain or faults:
        raise AssertionError(f"{cfg.name}: prefill through the kernels "
                             f"strays from f32 ({judged}): rel {ours} vs "
                             f"plain {plain}, faults {faults}")


def moe_breakdown(torch, m, cfg, params, prompts):
    """Phase 5f': where an MoE layer's time goes, by stage (routing, the
    dispatch scatter, the experts' batched matmuls, the combine gather),
    timed with CUDA events on the first MoE layer's weights at the
    prefill's (8, 2048) tokens and at a decode step's 8, against the bytes
    bound of reading every expert's weights (what a capacity-based step
    does)."""
    MOE = m["moe"]
    layer = next(l for l in params["layers"] if "moe" in l)
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    batch, lens_d = prefill_batch(torch, prompts[:8], 2048)
    # the prompts' embeddings at unit RMS, the scale the router sees
    e = params["embed"]["w"][batch["tokens"].long()].float()
    x = (e * torch.rsqrt(e.square().mean(-1, keepdim=True) + 1e-6)).to(
        layer["moe"]["up"].dtype)
    del e
    mask = (torch.arange(2048, device="cuda")[None, :] < lens_d[:, None])
    wbytes = sum(layer["moe"][k].numel() * layer["moe"][k].element_size()
                 for k in ("up", "gate", "down"))
    out = {}
    for what, xs, tm in (("prefill", x, mask), ("decode", x[:, :1], None)):
        T = xs.shape[0] * xs.shape[1]
        cap = MOE.capacity_of(T, mc)
        xt = xs.reshape(T, -1)
        with torch.no_grad():
            r = MOE.route(layer["moe"], xt, mc, cap, tm)
            buf = MOE.dispatch(xt, r, E, K, cap)
            ob = MOE.expert_ffn(layer["moe"], buf, cfg.act)
            stages = {
                "route": lambda: MOE.route(layer["moe"], xt, mc, cap, tm),
                "dispatch": lambda: MOE.dispatch(xt, r, E, K, cap),
                "experts": lambda: MOE.expert_ffn(layer["moe"], buf,
                                                  cfg.act),
                "combine": lambda: MOE.combine(ob, r, tm is not None),
                "moe_apply": lambda: MOE.moe_apply(layer["moe"], xs, mc,
                                                   cfg.act, token_mask=tm)}
            ms = {k: cuda_ms(torch, f, reps=5) for k, f in stages.items()}
        kept = int((r["keep"] & (r["e"] < E)).sum().item())
        routed = int((r["e"] < E).sum().item())
        out[what] = dict(tokens=T, capacity=cap, routed=routed, kept=kept,
                         stage_ms=ms,
                         experts_bytes_bound_ms=wbytes / PEAK_BYTES * 1e3)
        del r, buf, ob
    emit(phase="moe_breakdown", arch=cfg.name, experts=E, top_k=K,
         expert_weight_gb_per_layer=wbytes / 1e9,
         expert_weight_gb_all_layers=wbytes * sum(cfg.moe_layer_mask()) / 1e9,
         **out)
    torch.cuda.empty_cache()


def serve_path(torch, m, counts, arch: str, cfg=None,
               cli: bool = True) -> dict:
    """Phases 5-6 (granite), 5c (glm4, codeqwen; ``cli=False``), 5f
    (qwen3-moe), 9 (mamba2) and 9c (the one-period jamba, ``cfg``): the
    config at full width through the engine, its profile (and an MoE
    config's stage breakdown), the prefill logit gate, then the reduced
    serve CLI on the card, every launch on the CUDA-core route (f32).
    Returns the prefill kernels' launches over the full-width engine
    run."""
    cfg = cfg or m["get_config"](arch)
    launches, params, prompts = serve_full_width(torch, m, counts, cfg)
    profile_steps(torch, cfg, params, prompts, m["prefill"],
                  m["decode_step"])
    if cfg.moe is not None:
        moe_breakdown(torch, m, cfg, params, prompts)
    if arch in GATE_LAYERS:
        del params
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, n_layers=GATE_LAYERS[arch])
        params = m["init_params"](
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
    prefill_gate(torch, m, cfg, params, prompts, GATE_ROWS.get(arch, 8))
    del params
    torch.cuda.empty_cache()
    if not cli:
        return launches

    counts.zero()
    out = m["serve_main"](arch)
    rcfg = m["get_reduced"](arch)
    _check_prefill_launches(rcfg, counts.read(), counts.routes(),
                            out["prefill_calls"], "cuda_core",
                            "serve_main " + arch, stats=out)
    if out["requests"] != 16:
        raise AssertionError(f"serve_main: {out}")
    emit(phase="serve_main_reduced", launches=counts.read(),
         routes={k: counts.routes()[k] for k in prefill_launches(rcfg)},
         **out)
    return launches


# phase 5d: granite at full width under live traffic (a Poisson trace at
# about the closed batch's completion rate, 16 x 32 tokens in ~8 s) with a
# KV pool of 384 blocks of 16 (37.5% of the 1024 that cover 8 slots of
# 2048), so that evictions happen, and a 5 s TTFT SLO
LIVE = dict(n=32, rate=2.0, plen=(16, 1500), max_tokens=32, slots=8,
            cache_len=2048, pools=(384, 256), block=16, slo_ms=5000.0)
# phase 5e (a) serves the first 16 of those 32 prompts at once, two waves
# of the 8 slots, to keep the script's time down
AT_ONCE = 16


def _live_trace(m, vocab: int, rate: float):
    return m["poisson_trace"](vocab, LIVE["n"], rate, seed=0,
                              plen_range=LIVE["plen"],
                              max_tokens=LIVE["max_tokens"])


def _submit_now(sched, trace):
    """Submit a trace on the scheduler's real clock, starting now."""
    t0 = sched.clock.now()
    sched.submit_trace([(t0 + t, r) for t, r in trace])
    return t0


def serve_continuous_full_width(torch, m, counts):
    """Phase 5d: full-width granite-3-2b (bf16) through ``ServeScheduler``
    on the real clock: an open-loop Poisson trace, SLO shedding and an
    oversubscribed paged-KV pool.  Returns the K1 launches, the params and
    the requests, and each request's eviction count."""
    cfg = m["get_config"]("granite-3-2b")
    params = m["init_params"](
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    L = LIVE
    for pool in L["pools"]:
        trace = _live_trace(m, cfg.vocab, L["rate"])
        sched = m["ServeScheduler"](
            cfg, params, slots=L["slots"], cache_len=L["cache_len"],
            max_kv_blocks=pool, kv_block_size=L["block"],
            slo_deadline_ms=L["slo_ms"], device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.zero()
        t0 = _submit_now(sched, trace)
        sched.run()
        torch.cuda.synchronize()
        wall = sched.clock.now() - t0
        launches, routes = counts.read(), counts.routes()
        s = sched.stats()
        if s["evictions"]:
            break
        emit(phase="serve_continuous_no_eviction", pool_blocks=pool,
             peak_blocks=s["kv"]["peak_blocks_in_use"],
             why="the trace never held more blocks than the pool; "
                 "tightening it")
    reqs = [r for _, r in trace]
    _check_prefill_launches(cfg, launches, routes, s["prefill_calls"],
                            "tensor_core", "serve_continuous_full_width")
    kv = s["kv"]
    short = [r.rid for r in sched.completed
             if len(r.generated) != L["max_tokens"]
             and len(r.prompt) + len(r.generated) < L["cache_len"] - 1]
    if (s["completed"] + s["shed"] != L["n"] or kv["used_blocks"]
            or kv["peak_blocks_in_use"] > kv["total_blocks"]
            or not s["evictions"] or short):
        raise AssertionError(f"serve_continuous_full_width: {s}; short "
                             f"requests {short}")
    tokens = sum(len(r.generated) for r in sched.completed)
    slo_tokens = sum(len(r.generated) for r in sched.completed
                     if r.met_deadline())
    emit(phase="serve_continuous_full_width", arch=cfg.name,
         trace="poisson", requests=L["n"], rate_qps=L["rate"],
         slots=L["slots"], cache_len=L["cache_len"],
         kv_pool=[kv["total_blocks"], kv["block_size"]],
         slo_deadline_ms=L["slo_ms"], completed=s["completed"],
         shed=s["shed"], slo_met=s["slo_met"], evictions=s["evictions"],
         failed_grows=kv["failed_grows"],
         peak_blocks_in_use=kv["peak_blocks_in_use"], tokens=tokens,
         wall_s=wall, tokens_per_s=tokens / wall,
         goodput_req_s=s["slo_met"] / wall, goodput_tok_s=slo_tokens / wall,
         prompt_tokens=int(sum(len(r.prompt) for r in reqs)),
         prefill_calls=s["prefill_calls"], decode_steps=s["decode_steps"],
         launches=launches, routes=routes["flash_attention_fwd"],
         **{k: s[k] for k in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
                              "tpot_p99_s", "queue_wait_p50_s",
                              "queue_wait_p99_s")},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    n = launches["flash_attention_fwd"]
    del sched
    torch.cuda.empty_cache()

    # phase 5d': the scheduler's decode ticks (admission, KV growth, the
    # decode step) with 8 requests running, under the profiler
    prof = m["ServeScheduler"](cfg, params, slots=L["slots"],
                               cache_len=L["cache_len"], device="cuda")
    for r in reqs[:L["slots"]]:
        prof.submit(m["Request"](rid=r.rid, prompt=r.prompt,
                                 max_tokens=L["max_tokens"]))
    prof.step()

    def ticks():
        for _ in range(8):
            prof.step()
    device_profile(torch, ticks, arch=cfg.name, what="scheduler_decode",
                   steps=8)
    del prof
    torch.cuda.empty_cache()
    return n, params, reqs


def scheduler_token_identity(torch, m, counts, params, live_reqs):
    """Phase 5e.  (a) Full-width granite in bf16: the first ``AT_ONCE`` of
    the live trace's prompts arriving at once through the scheduler
    (default pool) and through the plain engine give the same greedy
    tokens and the same prefill batches.  Then, not gated, phase 5d's
    evicted requests against the same prompts served unevicted by the
    engine: re-prefilling prompt + generated through K1 rounds differently
    in bf16 from the incremental decode, so a near tie may flip an argmax.
    (b) The reduced granite in f32 on the card: an oversubscribed pool (8
    blocks of 8, 3 slots of 64) evicts, and the tokens equal an
    unconstrained run's."""
    cfg = m["get_config"]("granite-3-2b")
    L = LIVE
    trace = _live_trace(m, cfg.vocab, 1e6)
    if any(not np.array_equal(r.prompt, w.prompt)
           for (_, r), w in zip(trace, live_reqs)):
        raise AssertionError("the trace's prompts depend on its rate")
    trace = trace[:AT_ONCE]
    sched = m["ServeScheduler"](cfg, params, slots=L["slots"],
                                cache_len=L["cache_len"], device="cuda")
    engine = m["ServeEngine"](cfg, params, slots=L["slots"],
                              cache_len=L["cache_len"], device="cuda")
    for _, r in trace:
        engine.submit(m["Request"](rid=r.rid, prompt=r.prompt,
                                   max_tokens=r.max_tokens))
    counts.zero()
    t0 = _submit_now(sched, trace)
    sched.clock.sleep_until(t0 + trace[-1][0])    # all have arrived
    sched.run()
    engine.run()
    launches, routes = counts.read(), counts.routes()
    calls = sched.stats["prefill_calls"] + engine.stats["prefill_calls"]
    _check_prefill_launches(cfg, launches, routes, calls, "tensor_core",
                            "token identity (a)")
    got = {r.rid: r.generated for r in sched.completed}
    want = {r.rid: r.generated for r in engine.completed}
    if (got != want or len(got) != AT_ONCE
            or sched.stats["prefill_calls"] != engine.stats["prefill_calls"]
            or sched.stats["evictions"]):
        differ = sum(got.get(k) != v for k, v in want.items())
        raise AssertionError(
            f"token identity (a): {differ} of {len(want)} requests differ; "
            f"{len(got)} completed; prefill calls "
            f"{sched.stats['prefill_calls']} vs "
            f"{engine.stats['prefill_calls']}")
    emit(phase="scheduler_token_identity_full_width", arch=cfg.name,
         dtype="bfloat16", requests=len(got), tokens_equal=True,
         prefill_calls=sched.stats["prefill_calls"], launches=launches)
    del sched, engine

    evicted = [r for r in live_reqs if r.evictions and r.status == "done"]
    engine = m["ServeEngine"](cfg, params, slots=L["slots"],
                              cache_len=L["cache_len"], device="cuda")
    for r in evicted:
        engine.submit(m["Request"](rid=r.rid, prompt=r.prompt,
                                   max_tokens=r.max_tokens))
    engine.run()
    want = {r.rid: r.generated for r in engine.completed}
    first = {r.rid: next((i for i, (a, b) in enumerate(
        zip(r.generated, want[r.rid])) if a != b), None) for r in evicted}
    emit(phase="scheduler_eviction_divergence_bf16", arch=cfg.name,
         evicted=len(evicted),
         evictions={r.rid: r.evictions for r in evicted},
         first_diverging_token={k: v for k, v in first.items()
                                if v is not None})
    del engine
    torch.cuda.empty_cache()

    rcfg = m["get_reduced"]("granite-3-2b")
    rparams = m["init_params"](
        rcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, rcfg.vocab, size=int(rng.integers(4, 12)))
               for _ in range(6)]
    runs = []
    for pool in ({}, dict(max_kv_blocks=8, kv_block_size=8)):
        sched = m["ServeScheduler"](rcfg, rparams, slots=3, cache_len=64,
                                    device="cuda", **pool)
        for i, p in enumerate(prompts):
            sched.submit(m["Request"](rid=i, prompt=p, max_tokens=20))
        counts.zero()
        sched.run()
        _check_prefill_launches(rcfg, counts.read(), counts.routes(),
                                sched.stats["prefill_calls"], "cuda_core",
                                "token identity (b)")
        runs.append(sched)
    free, tight = runs
    got = {r.rid: r.generated for r in tight.completed}
    if (got != {r.rid: r.generated for r in free.completed} or len(got) != 6
            or not tight.stats["evictions"] or tight.kv.used_blocks):
        raise AssertionError(f"token identity (b): evictions "
                             f"{tight.stats['evictions']}, tokens {got}")
    emit(phase="scheduler_eviction_resume_reduced_f32", arch=rcfg.name,
         requests=6, evictions=tight.stats["evictions"],
         failed_grows=tight.kv.stats["failed_grows"],
         prefill_calls=[free.stats["prefill_calls"],
                        tight.stats["prefill_calls"]], tokens_equal=True)


def serve_main_continuous(torch, m, counts):
    """Phase 6b: the reduced serve CLI in continuous mode on the card, for
    granite-3-2b (K1) and mamba2-2.7b (K4); both reduced configs are f32,
    so every launch takes the CUDA-core route."""
    for arch in ("granite-3-2b", "mamba2-2.7b"):
        counts.zero()
        out = m["serve_main"](arch, arrival_rate=50.0, max_kv_blocks=16,
                              kv_block_size=8, device="cuda")
        launches, routes = counts.read(), counts.routes()
        if out["completed"] + out["shed"] != 16 or out["kv"]["used_blocks"]:
            raise AssertionError(f"serve_main continuous {arch}: {out}")
        _check_prefill_launches(m["get_reduced"](arch), launches, routes,
                                out["prefill_calls"], "cuda_core",
                                "serve_main continuous " + arch, stats=out)
        emit(phase="serve_main_continuous_reduced", launches=launches,
             routes=routes, **out)


def device_profile(torch, run, **labels):
    """``torch.profiler`` over ``run()``: device time by kernel, the device's
    busy share of the wall time.  Emits one JSON line; returns busy ms.
    Only the CUDA activity is traced: tracing every aten op on the host as
    well slows the host loop being measured and takes several times longer
    to aggregate, for the same device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpys), not the runtime's calls
    rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    emit(phase="profile", **labels, wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1 - busy_ms / wall_ms,
         top=[{"op": k[:60], "ms": ms, "calls": n} for ms, k, n in rows[:8]])
    if not busy_ms:
        raise AssertionError(f"the profiler saw no device time: {labels}")
    return busy_ms


def profile_steps(torch, cfg, params, prompts, prefill, decode_step):
    """Phases 5b and 9b: device time by operation over one (8, 2048)
    prefill and 8 decode steps, and the device's busy share of the wall
    time."""
    B, S = 8, 2048
    batch, lens_d = prefill_batch(torch, prompts[:B], S)
    device_profile(torch, lambda: prefill(params, cfg, batch, 2048,
                                          lengths=lens_d),
                   arch=cfg.name, what="prefill", steps=1)
    logits, state = prefill(params, cfg, batch, 2048, lengths=lens_d)
    tok = logits.argmax(-1).to(torch.int32)[:, None]

    def decode():
        nonlocal tok, state
        pos = lens_d.clone()
        for _ in range(8):
            logits, state = decode_step(params, cfg, state, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            pos = pos + 1
    device_profile(torch, decode, arch=cfg.name, what="decode", steps=8)
    del state
    torch.cuda.empty_cache()


def pn_bound(R: int, C: int, esize: int):
    """Least time (ms) of the stretch: bytes (x read once, the f32 output
    written once, lo and hi read once) over HBM bandwidth, or operations
    (subtract, multiply, two comparisons per element) over the f32 peak."""
    nbytes = R * C * (esize + 4) + 2 * 4 * C
    return (*least_ms(4 * R * C, nbytes, "float32"), nbytes)


def k5_vs_plain(torch, pn, pn_ref):
    """Phase 10: K5 against the plain stretch on reflectance-like data
    (0-4000) made on the card.  Returns the 4-band tile's f32 record."""
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    kernel = pn.percentile_norm_kernel
    for name, R, C, dtype_name in PN_SHAPES:
        x = torch.empty((R, C), device="cuda")
        for part in x.view(-1).split(2 ** 28):
            part.uniform_(0.0, 4000.0, generator=gen)
        x = x.to(getattr(torch, dtype_name))
        extra = {}
        if name == "s2_tile_4band":
            # the bounds come from the percentile helper, whose sort (not
            # the stretch) is most of the public op's time
            pct = pn_ref.percentiles(x, (1.0, 99.0))
            extra["percentile_helper_ms"] = cuda_ms(
                torch, lambda: pn_ref.percentiles(x, (1.0, 99.0)), reps=2)
            lo, hi = pct[0:1], pct[1:2]
        else:
            lo = torch.empty((1, C), device="cuda").uniform_(
                0.0, 400.0, generator=gen)
            hi = lo + torch.empty((1, C), device="cuda").uniform_(
                2000.0, 3600.0, generator=gen)
        out = kernel(x, lo, hi)
        torch.cuda.synchronize()
        err = 0.0
        for s0 in range(0, R, PN_CHUNK):
            want = pn_ref.stretch_ref(x[s0:s0 + PN_CHUNK], lo, hi)
            got = out[s0:s0 + PN_CHUNK]
            err = max(err, (got - want).abs().max().item())
            torch.testing.assert_close(got, want, atol=PN_TOL, rtol=0)
            del want, got
        del out
        torch.cuda.empty_cache()
        big = R * C > 2 ** 30
        kernel_ms = cuda_ms(torch, lambda: kernel(x, lo, hi),
                            reps=5 if big else 20)
        plain_ms = cuda_ms(torch, lambda: pn_ref.stretch_ref(x, lo, hi),
                           reps=2 if big else 5)
        torch.cuda.empty_cache()
        bound_ms, bound_by, nbytes = pn_bound(R, C, x.element_size())
        rec = dict(phase="k5_vs_plain", shape=name, dims=[R, C],
                   dtype=dtype_name, max_abs_err=err, tol=PN_TOL,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   kernel_gbps=nbytes / kernel_ms / 1e6,
                   share_of_bound=bound_ms / kernel_ms, **extra)
        emit(**rec)
        records[name] = rec
        del x, lo, hi
        torch.cuda.empty_cache()
    return records["s2_tile_4band"]


def _k5_only(launches: dict, n: int, what: str):
    others = {k: v for k, v in launches.items()
              if k != "percentile_norm" and v}
    if launches["percentile_norm"] != n or others:
        raise AssertionError(f"{what}: launches {launches}, want "
                             f"percentile_norm {n} and nothing else")


def _seg_record(torch, res, width, batch, optimizer, lr):
    steady = (res["steps"] - 1) / (res["train_s"] - res["first_step_s"])
    losses = res["losses"]
    if not np.all(np.isfinite(losses)) or res["params"] != SEG_PARAMS[
            res["model"]]:
        raise AssertionError(f"{res['model']}: losses {losses}, params "
                             f"{res['params']}")
    return dict(model=res["model"], params=res["params"], width=width,
                batch=batch, optimizer=optimizer, lr=lr, steps=res["steps"],
                losses=losses, train_s=res["train_s"],
                first_step_s=res["first_step_s"],
                steps_per_s=res["steps"] / res["train_s"],
                steady_steps_per_s=steady,
                chips_per_s=res["chips_seen"] / res["train_s"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                val={k: res[k] for k in ("precision", "recall", "f1", "iou",
                                         "accuracy")})


def burned_area(torch, m, counts) -> int:
    """Phase 11: the burned-area study at full width.  Returns K5's
    launches on it."""
    kept = []
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    t0 = time.perf_counter()
    split = m["build_dataset"](4, 2048, 256, "cuda", min_frac=0.10,
                               on_scene=lambda s, n: kept.append((s, n)))
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    _k5_only(counts.read(), 4, "build_dataset")
    chips = {k: len(v) for k, v in split.items()}
    if chips != BA_CHIPS:
        raise AssertionError(f"chips {chips}, want {BA_CHIPS}")
    emit(phase="burned_area_data", scenes=4, size=2048, chip=256,
         chips=chips, seconds=data_s)

    res = m["train_segmentation"]("unet", split, lr=1e-3, optimizer="adam",
                                  epochs=4, batch=16, width=16,
                                  device="cuda", seed=0)
    emit(phase="burned_area_train", epochs=4,
         **_seg_record(torch, res, 16, 16, "adam", 1e-3))
    for name in ("unetpp", "deeplabv3", "deeplabv3plus"):
        torch.cuda.reset_peak_memory_stats()
        res = m["train_segmentation"](name, split, lr=1e-2,
                                      optimizer="lamb", epochs=1, batch=16,
                                      width=16, device="cuda", seed=0)
        emit(phase="burned_area_train", epochs=1,
             **_seg_record(torch, res, 16, 16, "lamb", 1e-2))
    launches = counts.read()
    _k5_only(launches, 4, "the burned-area path")

    # the scenes the path normalized, against numpy and the plain stretch
    errs = []
    for scene, norm in kept:
        want = m["percentile_stretch"](scene.raster)
        plain = m["percentile_normalize"](
            torch.from_numpy(scene.raster).cuda(), backend="torch")
        errs.append({"scene": scene.scene_id,
                     "vs_numpy": float(np.abs(norm.cpu().numpy()
                                              - want).max()),
                     "vs_plain": (norm - plain).abs().max().item()})
    emit(phase="burned_area_scenes", max_abs_err=errs, tol_numpy=1e-5,
         tol_plain=PN_TOL)
    if any(e["vs_numpy"] > 1e-5 or e["vs_plain"] > PN_TOL for e in errs):
        raise AssertionError(f"normalized scenes stray: {errs}")
    del kept
    torch.cuda.empty_cache()

    # one U-Net step under the profiler
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m["seg_init"]("unet", gen, width=16, device="cuda")
    for t in m["tree_leaves"](params):
        t.requires_grad_(True)
    opt = m["get_optimizer"]("adam")
    state = opt.init(params)
    x, mk = next(iter(m["prefetch"](m["ChipLoader"](split["train"], 16),
                                    device="cuda")))

    def step(i=0):
        m["train_step"](lambda p: m["seg_loss"]("unet", p, x, mk), params,
                        opt, state, i, 1e-3)
    step()
    device_profile(torch, step, model="unet", what="train_step", batch=16,
                   chip=256, steps=1)
    return launches["percentile_norm"]


def forward_vs_cpu(torch, m):
    """Phase 11b: each vision model's forward on the card (cuDNN, TF32 off)
    against the same weights on the CPU, at batch 2 x 64 x 64."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand((2, 64, 64, 3), device="cuda", generator=gen)
    y = torch.rand((2, 64, 64, 3), device="cuda", generator=gen)
    errs = {}
    with torch.no_grad():
        for name in SEG_PARAMS:
            if name == "changeformer":
                p = m["changeformer_init"](gen, in_ch=3, device="cuda")
                run = m["changeformer_apply"]
                ins = (x, y)
            else:
                p = m["seg_init"](name, gen, width=16, device="cuda")
                run = functools.partial(m["seg_apply"], name)
                ins = (x,)
            got = run(p, *ins)
            want = run(_map(p, lambda t: t.cpu()), *(t.cpu() for t in ins))
            errs[name] = (got.cpu() - want).abs().max().item()
            torch.testing.assert_close(got.cpu(), want, atol=FWD_TOL,
                                       rtol=FWD_TOL)
    emit(phase="vision_forward_vs_cpu", batch=[2, 64, 64],
         max_abs_err=errs, tol=FWD_TOL)


def deforestation(torch, m, counts) -> int:
    """Phase 12: the deforestation study at the paper's 256 chip.  Returns
    K5's launches on it."""
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    pairs = m["build_pairs"](6, 256, "cuda")
    torch.cuda.synchronize()
    _k5_only(counts.read(), 12, "build_pairs")
    res = m["train_changeformer"](pairs, lr=1e-3, steps=60, device="cuda",
                                  seed=0)
    launches = counts.read()
    _k5_only(launches, 12, "the deforestation path")
    errs = []
    for i, (a3, b3, mk) in enumerate(pairs):
        a, b, want_m = m["synth_change_pair"](f"defo-{i}", 256, 256,
                                              bands=4, seed=i)
        errs.append(max(float(np.abs(t.cpu().numpy()
                                     - m["nir_rg"](r)).max())
                        for t, r in ((a3, a), (b3, b))))
        if not np.array_equal(mk.cpu().numpy(), want_m):
            raise AssertionError(f"pair {i}: the change mask differs")
    losses = res["losses"]
    emit(phase="deforestation_train", model="changeformer",
         params=res["params"], pairs=[4, 2], size=256, steps=res["steps"],
         losses=losses, train_s=res["train_s"],
         steps_per_s=res["steps"] / res["train_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         composite_max_abs_err_vs_numpy=errs,
         test={k: res[k] for k in ("precision", "recall", "f1", "iou",
                                   "accuracy")})
    if (max(errs) > 1e-5 or not np.all(np.isfinite(losses))
            or res["params"] != SEG_PARAMS["changeformer"]):
        raise AssertionError(f"deforestation: composite errors {errs}, "
                             f"losses {losses}, params {res['params']}")
    del pairs
    torch.cuda.empty_cache()
    return launches["percentile_norm"]


def vision_cli(torch, m, counts):
    """Phase 13: the reduced vision CLI on the card."""
    counts.zero()
    out = m["vision_main"](["--device", "cuda"])
    launches = counts.read()
    want = 4 + 2 * 6
    _k5_only(launches, want, "vision main")
    if out["percentile_norm_launches"] != want or not np.isfinite(
            out["changeformer"]["final_loss"]):
        raise AssertionError(f"vision main: {out}")
    emit(phase="vision_main_reduced", launches=launches, chips=out["chips"],
         unet=out["models"][0], changeformer=out["changeformer"])


# the run API phases (14-18): full-width training through ``run train``,
# then the reduced configs
RUN_TRAIN_ARGV = ["run", "train", "--arch", "stablelm-1.6b", "--full",
                  "--batch", "8", "--seq", "2048", "--precision", "bf16",
                  "--steps", "4", "--log_every", "0"]


def _report_of(text: str) -> dict:
    """The RunReport JSON that ``run`` prints last (an indented object
    whose first line is ``{``)."""
    start = text.rfind("\n{\n")
    return json.loads(text[start + 1:] if start >= 0 else text)


def launch_run(m, argv) -> tuple:
    """``python -m repro_torch.launch`` in this process (so the launch
    counters see it): its exit code and the report it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = m["launch_main"](list(argv))
    return rc, _report_of(buf.getvalue())


def _check_report(rc, report, what: str):
    if rc != 0 or report["status"] != "succeeded":
        raise AssertionError(f"{what}: exit {rc}, status {report['status']}"
                             f", error {report.get('error')}: "
                             f"{report['metrics'].get('traceback', '')}")


def _all_tensor_core(routes: dict, launches: dict, what: str):
    if any(r["cuda_core"] or r["tensor_core"] != launches[name]
           or launches[name] == 0 for name, r in routes.items()):
        raise AssertionError(f"{what}: K1-K3 routes {routes} (launches "
                             f"{launches}): every launch must take the "
                             f"tensor cores")


def run_api_train_full_width(torch, m, counts) -> dict:
    """Phase 14: ``run train --full`` (stablelm-1.6b, bf16, 8 x 2048, 4
    steps) through the run API's front door, in this process: a
    ``succeeded`` report, 4 finite losses, K1-K3 launched as
    ``train_launches`` predicts, all on the tensor cores.  Returns the
    launches and the report's numbers for the records."""
    cfg = m["get_config"]("stablelm-1.6b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    t0 = time.perf_counter()
    rc, report = launch_run(m, RUN_TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = counts.read(), counts.routes(counts.FLASH)
    _check_report(rc, report, "run train --full")
    met = report["metrics"]
    losses = met["losses"]
    if len(losses) != 4 or not np.all(np.isfinite(losses)):
        raise AssertionError(f"run train --full: losses {losses}")
    want = train_launches(cfg, 4)
    if launches != want:
        raise AssertionError(f"run train --full: launches {launches} != "
                             f"{want}")
    _all_tensor_core(routes, launches, "run train --full")
    rec = dict(arch=met["arch"], params=met["params"], device=met["device"],
               losses=losses, steps_per_s=met["steps_per_s"],
               loop_step_s=met["pure_step_s"] / met["steps_run"],
               loop_wall_s=met["wall_s"],
               report_wall_s=report["wall_s"], call_wall_s=wall,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, routes=routes,
               phase4_step_s_pr20=0.9001)
    emit(phase="run_api_train_full_width", argv=RUN_TRAIN_ARGV, **rec)
    torch.cuda.empty_cache()
    return rec


def _cli(args, timeout: int = 600):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory() as cwd:
        return subprocess.run([sys.executable, "-m", "repro_torch.launch",
                               *args], env=env, cwd=cwd, capture_output=True,
                              text=True, timeout=timeout)


def run_api_cli_subprocess(m) -> dict:
    """Phase 15: ``python -m repro_torch.launch run serve`` as a real
    subprocess on the card: granite (K1) with the same counts as a direct
    ``serve_main`` call, mamba2 (K4), and ``run bogus`` exiting 2.
    Returns the subprocesses' K1 and K4 launches."""
    out = {}
    direct = m["serve_main"]("granite-3-2b", requests=8)
    for arch, stat in (("granite-3-2b", "flash_attention_launches"),
                       ("mamba2-2.7b", "ssd_scan_launches")):
        t0 = time.perf_counter()
        proc = _cli(["run", "serve", "--arch", arch, "--requests", "8"])
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"run serve --arch {arch}: exit "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}"
                                 f"{proc.stdout[-3000:]}")
        report = _report_of(proc.stdout)
        met = report["metrics"]
        if report["status"] != "succeeded" or not met[stat] > 0:
            raise AssertionError(f"run serve --arch {arch}: {report}")
        if arch == "granite-3-2b":
            keys = ("requests", "tokens", "decode_steps", "prefill_calls",
                    "flash_attention_launches")
            if any(met[k] != direct[k] for k in keys):
                raise AssertionError(
                    f"run serve (subprocess) {[met[k] for k in keys]} != "
                    f"serve_main {[direct[k] for k in keys]} for {keys}")
        out[arch] = met[stat]
        emit(phase="run_api_cli_subprocess", arch=arch, device=met["device"],
             exit_code=proc.returncode, status=report["status"],
             process_wall_s=wall, report_wall_s=report["wall_s"],
             tokens=met["tokens"], tokens_per_s=met["tokens_per_s"],
             **{stat: met[stat]})
    proc = _cli(["run", "bogus"], timeout=120)
    if proc.returncode != 2:
        raise AssertionError(f"run bogus: exit {proc.returncode}, want 2")
    emit(phase="run_api_cli_subprocess", argv=["run", "bogus"],
         exit_code=proc.returncode, stderr=proc.stderr.strip())
    return out


def run_api_train_resume_bitwise(torch, m, counts) -> dict:
    """Phase 16: reduced stablelm (bf16, the tensor-core route) in
    deterministic mode through ``run train``: preempted before step 3 (a
    ``failed`` report), then ``--resume``; its losses and final checkpoint
    equal an uninterrupted ``train_main`` call's, bit for bit."""
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            oracle = os.path.join(tmp, "oracle")
            base = m["train_main"]("stablelm-1.6b", steps=12, log_every=0,
                                   precision="bf16", device="cuda",
                                   checkpoint_dir=oracle,
                                   checkpoint_async=False)
            ck = os.path.join(tmp, "ck")
            argv = ["run", "train", "--steps", "12", "--log_every", "0",
                    "--precision", "bf16", "--checkpoint_dir", ck,
                    "--checkpoint_every", "2"]
            counts.zero()
            rc, pre = launch_run(m, argv + ["--preempt_at_step", "3"])
            if rc != 1 or pre["status"] != "failed" or not str(
                    pre["error"]).startswith("Preemption"):
                raise AssertionError(f"preempted run train: exit {rc}, "
                                     f"{pre['status']}, {pre['error']}")
            rc, res = launch_run(m, argv + ["--resume"])
            launches, routes = counts.read(), counts.routes(counts.FLASH)
            _check_report(rc, res, "run train --resume")
            load, ls = m["load_checkpoint"], m["list_checkpoints"]
            got, gstep = load(ls(ck)[-1][1])
            want, wstep = load(ls(oracle)[-1][1])
            same = (set(got) == set(want) and gstep == wstep == 12 and all(
                np.array_equal(got[k], want[k]) for k in want))
            met = res["metrics"]
            if (met["resumed_from_step"] != 2
                    or met["losses"] != base["losses"][2:] or not same):
                raise AssertionError(
                    f"run train --resume is not bitwise: resumed from "
                    f"{met['resumed_from_step']}, losses {met['losses']} vs "
                    f"{base['losses'][2:]}, final arrays equal: {same}")
    finally:
        torch.use_deterministic_algorithms(False)
    _all_tensor_core(routes, launches, "run train --resume")
    emit(phase="run_api_train_resume_bitwise", precision="bf16",
         preempted_error=pre["error"], resumed_from_step=2,
         losses_equal=True, final_checkpoint_bitwise=True,
         launches=launches, routes=routes)
    return launches


def campaign_local(torch, m, counts) -> dict:
    """Phase 17: a two-learning-rate grid of reduced stablelm (bf16)
    through ``Orchestrator.submit_runs(attach_payload=True)`` and
    ``run_local`` on the card: each job's first attempt is preempted
    before step 3, the retry resumes from step 2 under the retry env, and
    the results land on the PVC and in S3 with the checkpoints."""
    with tempfile.TemporaryDirectory() as tmp:
        grid = m["ExperimentGrid"]("lm", {"lr": [3e-4, 1e-3]})
        runs = [r.replace(overrides={
            **r.overrides, "steps": 6, "log_every": 0, "precision": "bf16",
            "checkpoint_every": 2, "preempt_at_step": 3,
            "s3_root": os.path.join(tmp, "s3"),
            "checkpoint_dir": os.path.join(tmp, "ck", r.run_name)})
            for r in grid.to_runs(kind="train", arch="stablelm-1.6b")]
        pvc = m["PersistentVolume"](tmp)
        s3 = m["S3Store"](tmp)
        orch = m["Orchestrator"](pvc, s3)
        orch.submit_runs(runs, attach_payload=True)
        counts.zero()
        t0 = time.perf_counter()
        recs = orch.run_local()
        wall = time.perf_counter() - t0
        launches, routes = counts.read(), counts.routes(counts.FLASH)
        jobs = {}
        for run in runs:
            rec = recs[run.run_name]
            res = json.loads(pvc.read_bytes(f"results/{run.run_name}.json"))
            hist = res["attempt_history"]
            met = (res["result"] or {}).get("metrics", {})
            ok = (rec.state.value == "Succeeded" and rec.attempts == 2
                  and [h["outcome"] for h in hist] == ["failed", "succeeded"]
                  and "Preemption" in hist[0]["error"]
                  and hist[1].get("resumed_from_step") == 2
                  and met.get("s3_objects", 0) > 0
                  and met.get("device") == "cuda"
                  and s3.exists(f"results/{run.run_name}.json"))
            if not ok:
                raise AssertionError(f"campaign_local {run.run_name}: "
                                     f"{rec.state}, {rec.attempts} attempts, "
                                     f"history {hist}, error {rec.error}")
            jobs[run.run_name] = dict(
                attempts=rec.attempts,
                attempt_history=[{k: h[k] for k in h if k != "wall_s"}
                                 for h in hist],
                s3_objects=met["s3_objects"], losses=met["losses"])
        summary = json.loads(pvc.read_bytes(
            "results/_local_run_summary.json"))
    _all_tensor_core(routes, launches, "campaign_local")
    emit(phase="campaign_local", jobs=jobs, wall_s=wall, launches=launches,
         routes=routes, local_run_summary=summary)
    return launches


def run_api_simulate(torch, m, peak_gb: float):
    """Phase 18: ``run simulate --campaign all``: the paper's 234 jobs,
    234 manifests and 4040.0 wall-hours; then, not gated, ``autobatch``
    for stablelm-1.6b at seq 2048 against the card's own budget."""
    with tempfile.TemporaryDirectory() as tmp:
        rc, report = launch_run(m, ["run", "simulate", "--campaign", "all",
                                    "--workdir", tmp])
    _check_report(rc, report, "run simulate")
    met = report["metrics"]
    if (met["jobs"], met["manifests"], met["total_wall_hours"]) != (
            234, 234, 4040.0):
        raise AssertionError(f"run simulate --campaign all: {met}")
    cfg = m["get_config"]("stablelm-1.6b")
    budget = m["MemoryBudget"].of_device("cuda")
    emit(phase="run_api_simulate", **met, wall_s=report["wall_s"],
         autobatch_stablelm_seq2048=m["autobatch"](cfg, 2048, budget=budget),
         budget_device_gb=budget.device_gb,
         budget_reserve_frac=budget.reserve_frac,
         measured_peak_gb_at_batch8=peak_gb)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def main() -> int:
    # cuBLAS reads this when it starts: with it (and deterministic mode in
    # phase 7) a resumed run repeats an uninterrupted one bitwise
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    from repro_torch.checkpoint import list_checkpoints, load_checkpoint
    from repro_torch.core import (ExperimentGrid, Orchestrator,
                                  PersistentVolume, S3Store)
    from repro_torch.core.autobatch import MemoryBudget, autobatch
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels.common import build_libraries
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.data.loader import ChipLoader, prefetch
    from repro_torch.data.normalize import nir_rg, percentile_stretch
    from repro_torch.data.rasters import synth_change_pair
    from repro_torch.kernels.percentile_norm import kernel as pn
    from repro_torch.kernels.percentile_norm import percentile_normalize
    from repro_torch.kernels.percentile_norm import ref as pn_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
    from repro_torch.launch import vision
    from repro_torch.launch.__main__ import main as launch_main
    from repro_torch.launch.serve import serve_main
    from repro_torch.launch.train import _LMDictBatches, train_main
    from repro_torch.models.changeformer import (changeformer_apply,
                                                 changeformer_init)
    from repro_torch.models.segmentation import seg_apply, seg_init, seg_loss
    from repro_torch.models import init_params
    from repro_torch.models import moe
    from repro_torch.models.layers import naive_attention
    from repro_torch.models.model import (cast_floating, decode_step,
                                          prefill, train_loss, unused_leaves)
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.serve import (Request, ServeEngine, ServeScheduler,
                                   poisson_trace)
    from repro_torch.train import (Preemption, TrainLoop, init_train_state,
                                   make_train_step)
    from repro_torch.tree import tree_leaves, tree_unflatten
    m = dict(get_config=get_config, get_optimizer=get_optimizer,
             init_train_state=init_train_state,
             make_train_step=make_train_step, warmup_cosine=warmup_cosine,
             LMDictBatches=_LMDictBatches, TrainLoop=TrainLoop,
             train_loss=train_loss, unused_leaves=unused_leaves,
             cast_floating=cast_floating, tree_leaves=tree_leaves,
             tree_unflatten=tree_unflatten,
             train_main=train_main, Preemption=Preemption,
             load_checkpoint=load_checkpoint,
             list_checkpoints=list_checkpoints, init_params=init_params,
             ServeEngine=ServeEngine, Request=Request, prefill=prefill,
             ServeScheduler=ServeScheduler, poisson_trace=poisson_trace,
             decode_step=decode_step, serve_main=serve_main,
             get_reduced=get_reduced, build_dataset=vision.build_dataset,
             train_segmentation=vision.train_segmentation,
             build_pairs=vision.build_pairs,
             train_changeformer=vision.train_changeformer,
             train_step=vision.train_step, vision_main=vision.main,
             percentile_stretch=percentile_stretch, nir_rg=nir_rg,
             percentile_normalize=percentile_normalize,
             synth_change_pair=synth_change_pair, seg_init=seg_init,
             seg_apply=seg_apply, seg_loss=seg_loss,
             changeformer_init=changeformer_init,
             changeformer_apply=changeformer_apply, ChipLoader=ChipLoader,
             prefetch=prefetch, moe=moe, ssd_scan=ssd_scan,
             launch_main=launch_main, ExperimentGrid=ExperimentGrid,
             Orchestrator=Orchestrator, PersistentVolume=PersistentVolume,
             S3Store=S3Store, MemoryBudget=MemoryBudget, autobatch=autobatch)

    # f32 products in the plain versions stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    # phase 1: one nvcc per source, all started together, and one more
    # for K4's ptxas report
    t0 = time.perf_counter()
    ptxas_dir = tempfile.mkdtemp()
    ptxas = ptxas_start(ssd.SOURCE, ptxas_dir)
    build_libraries([fa.SOURCE, fa.BWD_SOURCE, ssd.SOURCE, pn.SOURCE])
    fa.library()
    fa.bwd_library()
    ssd.library()
    pn.library()
    emit(phase="build", sources=sorted({v[0] for v in KERNELS.values()}),
         seconds=time.perf_counter() - t0)
    emit(phase="ptxas", source=KERNELS["ssd_scan"][0],
         tensor_core=ptxas_report(ptxas, "ssd_scan_mma"))
    shutil.rmtree(ptxas_dir)

    k1_recs = kernel_vs_plain(torch, F, fa, ref.attention_ref)
    kb = bwd_vs_plain(torch, F, fa, ref)
    function_vs_plain(torch, flash_attention, naive_attention)

    # the training path
    counts = _Counts(fa, ssd, pn)
    train_launches, state, data = train_full_width(torch, m, counts)
    train_grads_vs_f32(torch, m, state.params, data)
    del state, data
    torch.cuda.empty_cache()

    # the dense serving path, then the other two dense decoders at full
    # width, then live traffic through the scheduler
    serve_launches = serve_path(torch, m, counts, "granite-3-2b")
    wide_launches = {arch: serve_path(torch, m, counts, arch, cli=False)
                     for arch in ("glm4-9b", "codeqwen1.5-7b")}
    live_launches, params, live_reqs = serve_continuous_full_width(
        torch, m, counts)
    scheduler_token_identity(torch, m, counts, params, live_reqs)
    del params
    torch.cuda.empty_cache()
    serve_main_continuous(torch, m, counts)

    # the MoE serving path (this slice's main path): full-width qwen3-moe
    moe_launches = serve_path(torch, m, counts, "qwen3-moe-30b-a3b",
                              cli=False)

    train_cli_resume(torch, m, counts)
    train_cli_resume(torch, m, counts, precision="bf16")

    # the SSM serving path
    k4 = ssd_vs_plain(torch, ssd, ssd_chunked_ref)
    ssd_launches = serve_path(torch, m, counts, "mamba2-2.7b")
    # the hybrid (this slice's main path): K1, K4 and the MoE in one
    # prefill, then the reduced jamba's CLI
    hybrid_launches = serve_path(torch, m, counts, "jamba-1.5-large-398b",
                                 cfg=jamba_one_period(get_config))
    # mamba2 training on the card
    ssd_train_launches = train_mamba2(torch, m, counts)

    # the run API and the local campaign layer
    api_train = run_api_train_full_width(torch, m, counts)
    api_cli = run_api_cli_subprocess(m)
    api_resume = run_api_train_resume_bitwise(torch, m, counts)
    api_campaign = campaign_local(torch, m, counts)
    run_api_simulate(torch, m, api_train["peak_mem_gb"])
    launches_run_api = {name: api_train["launches"][name] + api_resume[name]
                        + api_campaign[name] for name in counts.FLASH}

    # the vision paths: both studies normalize every scene through K5
    k5 = k5_vs_plain(torch, pn, pn_ref)
    pn_launches = burned_area(torch, m, counts)
    forward_vs_cpu(torch, m)
    pn_launches += deforestation(torch, m, counts)
    vision_cli(torch, m, counts)

    emit(phase="done", seconds=time.perf_counter() - t_start)
    k2 = dict(ms=kb["dq_kernel_ms"], bound_ms=kb["dq_bound_ms"],
              bound_by=kb["dq_bound_by"], max_abs_err=kb["max_abs_err"]["dq"],
              core_route=kb["route"])
    k3 = dict(ms=kb["dkv_kernel_ms"], bound_ms=kb["dkv_bound_ms"],
              bound_by=kb["dkv_bound_by"],
              max_abs_err=max(kb["max_abs_err"]["dk"],
                              kb["max_abs_err"]["dv"]),
              core_route=kb["route"])
    k1 = k1_recs[("granite_prefill", "bfloat16")]
    k1 = dict(ms=k1["kernel_ms"], bound_ms=k1["bound_ms"],
              bound_by=k1["bound_by"], max_abs_err=k1["max_abs_err_o"],
              plain_ms=k1["plain_ms"], library_ms=k1["library_ms"],
              core_route=k1["route"],
              launches_serve=serve_launches["flash_attention_fwd"],
              launches_serve_wide={a: n["flash_attention_fwd"]
                                   for a, n in wide_launches.items()},
              launches_serve_continuous=live_launches,
              launches_serve_moe=moe_launches["flash_attention_fwd"],
              launches_serve_hybrid=hybrid_launches["flash_attention_fwd"],
              launches_run_api_cli=api_cli["granite-3-2b"],
              shapes={name: {k: k1_recs[(name, "bfloat16")][k] for k in (
                  "kernel_ms", "bound_ms", "bound_by", "plain_ms",
                  "library_ms", "max_abs_err_o")}
                  for name in ("glm4_prefill", "codeqwen_prefill",
                               "qwen3_prefill")})
    rows = []
    for name, rec in (("flash_attention_fwd", k1),
                      ("flash_attention_bwd_dq", k2),
                      ("flash_attention_bwd_dkv", k3)):
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": train_launches[name],
                     "launches_run_api": launches_run_api[name],
                     "plain_ms": kb["plain_ms"],
                     "library_ms": kb["library_ms"], **rec})
    source, replaces = KERNELS["ssd_scan"]
    # no single PyTorch call computes the SSD scan: library_ms is null
    rows.append({"name": "ssd_scan", "route": "cuda", "source": source,
                 "replaces": replaces, "launches": ssd_launches["ssd_scan"],
                 "launches_serve_hybrid": hybrid_launches["ssd_scan"],
                 "launches_train": ssd_train_launches,
                 "launches_run_api_cli": api_cli["mamba2-2.7b"],
                 "max_abs_err": max(k4["max_abs_err_y"], k4["max_abs_err_h"]),
                 "ms": k4["kernel_ms"], "plain_ms": k4["plain_ms"],
                 "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
                 "library_ms": None, "core_route": k4["route"]})
    source, replaces = KERNELS["percentile_norm"]
    # no single PyTorch call computes the stretch: library_ms is null
    rows.append({"name": "percentile_norm", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": pn_launches, "max_abs_err": k5["max_abs_err"],
                 "ms": k5["kernel_ms"], "plain_ms": k5["plain_ms"],
                 "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
                 "library_ms": None})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. print the card's name and power limit; build the flash-attention
   kernels from ``src/repro_torch/.../csrc`` with nvcc (sm_90a), one nvcc
   per source, started together: the forward (K1) and the backward (K2
   dQ, K3 dK/dV);
2. hold K1 against its plain PyTorch version on the card, in bf16 and f32,
   at granite-3-2b's prefill shape and at ragged, windowed and MHA hd=128
   shapes (one JSON line per shape: errors, kernel / plain / library ms and
   the least time the card could take);
3. hold K2 and K3 against the plain backward, in bf16 and f32, at
   stablelm-1.6b's training shape, granite-3-2b's GQA shape and ragged,
   windowed and MHA hd=128 shapes, the same way; then the whole
   differentiable op (K1 -> K2 + K3) against autograd of plain attention;
4. train full-width stablelm-1.6b (24 layers, bf16, random weights from a
   seed) through ``TrainLoop``: AdamW, warmup-cosine, remat, the Markov
   token stream at batch 8 x seq 2048; K1 must launch 2 x 24 and K2 and
   K3 24 times a step; losses, steps/s, tokens/s, model FLOP utilisation
   and peak memory; ``torch.profiler`` over one step; then one (4, 2048)
   step's loss and gradients through the kernels and through plain
   attention, both bf16, each against plain attention in f32;
5. serve full-width granite-3-2b (40 layers, bf16, random weights from a
   seed) through ``ServeEngine``: 16 greedy requests, prompts of 16-1500
   tokens, 32 new tokens each, 8 slots; K1 must launch 40 x prefill calls;
   one prefill batch through the kernel and through plain attention, each
   held against an f32 prefill; ``torch.profiler`` over one prefill and 8
   decode steps;
6. run ``serve_main("granite-3-2b")`` (the reduced serve CLI) on the card;
7. run ``train_main("stablelm-1.6b")`` (the reduced train CLI) with
   checkpoints, preempt it, resume it, and hold it bitwise against an
   uninterrupted run, in PyTorch's deterministic mode.

The line before the last lists each ported kernel with its launches on
the main paths and its numbers at the training shape (K2, K3) or
granite's prefill shape (K1); the last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA card, or without the repository beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CSRC = "src/repro_torch/kernels/flash_attention/csrc/"
TPU_KERNELS = "src/repro/kernels/flash_attention/kernel.py"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_attention_fwd": (CSRC + "flash_fwd.cu", TPU_KERNELS + ":57"),
    "flash_attention_bwd_dq": (CSRC + "flash_bwd.cu", TPU_KERNELS + ":148"),
    "flash_attention_bwd_dkv": (CSRC + "flash_bwd.cu", TPU_KERNELS + ":179"),
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
            got = fa.flash_attention_bwd_kernel(q, k, v, do, lse, delta,
                                                **mask)
            torch.cuda.synchronize()
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
                       window=window, dtype=dtype_name,
                       max_abs_err=errs, tol=BWD_TOL,
                       dq_kernel_ms=dq_ms, dkv_kernel_ms=dkv_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       dq_bound_ms=b["dq"]["ms"], dq_bound_by=b["dq"]["by"],
                       dkv_bound_ms=b["dkv"]["ms"],
                       dkv_bound_by=b["dkv"]["by"],
                       fused_bound_ms=b["fused"]["ms"],
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
    """The launch counters of the three kernels, zeroed and read around
    one path."""

    def __init__(self, fa):
        self.fns = {"flash_attention_fwd": fa.flash_attention_fwd_kernel,
                    "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_kernel,
                    "flash_attention_bwd_dkv":
                        fa.flash_attention_bwd_dkv_kernel}

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}


def _param_count(tree) -> int:
    sizes = []
    _map(tree, lambda t: sizes.append(t.numel()))
    return sum(sizes)


def train_full_width(torch, m, counts):
    """Phase 4: full-width stablelm-1.6b through TrainLoop.  Returns the
    launches on the path, the state and the data stream."""
    cfg = m["get_config"]("stablelm-1.6b")
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
    total = 1 + TRAIN_STEPS
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = cfg.n_layers
    want = {"flash_attention_fwd": 2 * L * TRAIN_STEPS,
            "flash_attention_bwd_dq": L * TRAIN_STEPS,
            "flash_attention_bwd_dkv": L * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} (remat runs "
                             f"each layer's forward twice a step)")
    losses = loop.losses
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    tokens = TRAIN_B * TRAIN_S
    # model FLOPs: 6 N T for the weights the matmuls read (all but the
    # embedding table, which is gathered), plus attention fwd + bwd at
    # 12 hd per admitted causal (q, k) pair and head
    n_mm = cfg.param_count() - cfg.vocab * cfg.d_model
    attn = 12 * cfg.head_dim * cfg.n_heads * L * TRAIN_B \
        * valid_pairs(TRAIN_S, TRAIN_S, True, None)
    flops = 6 * n_mm * tokens + attn
    step_s = wall / TRAIN_STEPS
    emit(phase="train_full_width", arch=cfg.name, params=n_params,
         init_s=init_s, batch=[TRAIN_B, TRAIN_S], steps=TRAIN_STEPS,
         losses=losses, wall_s=wall, step_s=step_s,
         steps_per_s=1 / step_s, tokens_per_s=tokens / step_s,
         model_flops_per_step=flops,
         mfu_vs_989_tflops=flops / step_s / PEAK_FLOPS["bfloat16"],
         mfu_formula="(6*(N - vocab*d)*B*S + 12*hd*H*L*B*S(S+1)/2) / step_s"
                     " / 989e12",
         peak_mem_gb=peak_gb, launches=launches,
         pure_step_s=res["pure_step_s"])

    # phase 4b: one step under the profiler
    batch = data.next_batch()
    torch.cuda.synchronize()
    profiled = {}

    def one_step():
        profiled["state"] = step_fn(loop.state, batch)[0]
    device_profile(torch, one_step, what="train_step", steps=1)
    return launches, profiled["state"], data


def train_grads_vs_f32(torch, m, params, data):
    """Phase 4c: one (4, 2048) step's loss and gradients through the
    kernels (bf16) and through plain attention (bf16), each against plain
    attention in f32 on the same weights."""
    cfg = m["get_config"]("stablelm-1.6b")
    full = data.next_batch()
    batch = {k: v[:4] for k, v in full.items()}
    tree_leaves, tree_unflatten = m["tree_leaves"], m["tree_unflatten"]

    def value_and_grad(p, c):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        loss = m["train_loss"](tree_unflatten(p, leaves), c, batch)
        return loss.item(), torch.autograd.grad(loss, leaves)

    p32 = m["cast_floating"](params, torch.float32)
    c32 = dataclasses.replace(cfg, attention_backend="torch",
                              param_dtype="float32")
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
            cfg, attention_backend=backend))
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
    emit(phase="train_grads_vs_f32", batch=[4, TRAIN_S], loss_f32=l32,
         f32_step_s=f32_s, cuda_bf16=out["cuda"], torch_bf16=out["torch"])
    # a bf16 rounding of the loss (2**-9 of it) bounds the loss check
    # from below, so two tiny errors do not decide it
    c, t = out["cuda"], out["torch"]
    if (c["grad_rel_err"] > 2 * t["grad_rel_err"]
            or c["loss_abs_err"] > 2 * t["loss_abs_err"] + abs(l32) / 512):
        raise AssertionError(f"the kernel path strays from f32: {out}")


def train_cli_resume(torch, m, counts):
    """Phase 7: the reduced train CLI, preempted and resumed, bitwise
    against an uninterrupted run, in deterministic mode."""
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            kw = dict(steps=12, log_every=0, device="cuda")
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
            load, ls = m["load_checkpoint"], m["list_checkpoints"]
            got, gstep = load(ls(ck)[-1][1])
            want, wstep = load(ls(os.path.join(tmp, "oracle"))[-1][1])
            same = (set(got) == set(want) and gstep == wstep == 12 and all(
                np.array_equal(got[k], want[k]) for k in want))
            if (res["resumed_from_step"] != 2
                    or res["losses"] != base["losses"][2:] or not same):
                raise AssertionError(
                    f"resume is not bitwise: resumed from "
                    f"{res['resumed_from_step']}, losses {res['losses']} vs "
                    f"{base['losses'][2:]}, final arrays equal: {same}")
    finally:
        torch.use_deterministic_algorithms(False)
    emit(phase="train_main_reduced_resume", arch=res["arch"],
         resumed_from_step=res["resumed_from_step"],
         final_loss=res["final_loss"], losses_equal=True,
         final_checkpoint_bitwise=True, launches=launches,
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


def device_profile(torch, run, **labels):
    """``torch.profiler`` over ``run()``: device time by kernel, the device's
    busy share of the wall time.  Emits one JSON line; returns busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, memcpys): the aten ops that launch
    # them report the same device time again
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
    """Phase 5b: device time by operation over one (8, 2048) prefill and
    8 decode steps, and the device's busy share of the wall time."""
    B, S = 8, 2048
    batch, lens_d = prefill_batch(torch, prompts[:B], S)
    device_profile(torch, lambda: prefill(params, cfg, batch, 2048,
                                          lengths=lens_d),
                   what="prefill", steps=1)
    logits, state = prefill(params, cfg, batch, 2048, lengths=lens_d)
    tok = logits.argmax(-1).to(torch.int32)[:, None]

    def decode():
        nonlocal tok, state
        pos = lens_d.clone()
        for _ in range(8):
            logits, state = decode_step(params, cfg, state, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            pos = pos + 1
    device_profile(torch, decode, what="decode", steps=8)
    del state
    torch.cuda.empty_cache()


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
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels.common import build_libraries
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.launch.serve import serve_main
    from repro_torch.launch.train import _LMDictBatches, train_main
    from repro_torch.models import init_params
    from repro_torch.models.layers import naive_attention
    from repro_torch.models.model import (cast_floating, decode_step,
                                          prefill, train_loss)
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import (Preemption, TrainLoop, init_train_state,
                                   make_train_step)
    from repro_torch.tree import tree_leaves, tree_unflatten
    m = dict(get_config=get_config, get_optimizer=get_optimizer,
             init_train_state=init_train_state,
             make_train_step=make_train_step, warmup_cosine=warmup_cosine,
             LMDictBatches=_LMDictBatches, TrainLoop=TrainLoop,
             train_loss=train_loss, cast_floating=cast_floating,
             tree_leaves=tree_leaves, tree_unflatten=tree_unflatten,
             train_main=train_main, Preemption=Preemption,
             load_checkpoint=load_checkpoint,
             list_checkpoints=list_checkpoints)

    # f32 products in the plain versions stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    # phase 1: one nvcc per source, all started together
    t0 = time.perf_counter()
    build_libraries([fa.SOURCE, fa.BWD_SOURCE])
    fa.library()
    fa.bwd_library()
    emit(phase="build", sources=sorted({v[0] for v in KERNELS.values()}),
         seconds=time.perf_counter() - t0)

    k1 = kernel_vs_plain(torch, F, fa.flash_attention_fwd_kernel,
                         ref.attention_ref)
    kb = bwd_vs_plain(torch, F, fa, ref)
    function_vs_plain(torch, flash_attention, naive_attention)

    # the training path (this slice's main path)
    counts = _Counts(fa)
    train_launches, state, data = train_full_width(torch, m, counts)
    train_grads_vs_f32(torch, m, state.params, data)
    del state, data
    torch.cuda.empty_cache()

    # the serving path
    serve_launches, params, prompts = serve_full_width(
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

    train_cli_resume(torch, m, counts)

    emit(phase="done", seconds=time.perf_counter() - t_start)
    k2 = dict(ms=kb["dq_kernel_ms"], bound_ms=kb["dq_bound_ms"],
              bound_by=kb["dq_bound_by"], max_abs_err=kb["max_abs_err"]["dq"])
    k3 = dict(ms=kb["dkv_kernel_ms"], bound_ms=kb["dkv_bound_ms"],
              bound_by=kb["dkv_bound_by"],
              max_abs_err=max(kb["max_abs_err"]["dk"],
                              kb["max_abs_err"]["dv"]))
    k1 = dict(ms=k1["kernel_ms"], bound_ms=k1["bound_ms"],
              bound_by=k1["bound_by"], max_abs_err=k1["max_abs_err_o"],
              plain_ms=k1["plain_ms"], library_ms=k1["library_ms"],
              launches_serve=serve_launches)
    rows = []
    for name, rec in (("flash_attention_fwd", k1),
                      ("flash_attention_bwd_dq", k2),
                      ("flash_attention_bwd_dkv", k3)):
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": train_launches[name],
                     "plain_ms": kb["plain_ms"],
                     "library_ms": kb["library_ms"], **rec})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

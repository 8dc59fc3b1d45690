"""Hold builds of the flash-attention forward, or of the backward, against
each other on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.compare \\
        A.cu [B.cu ...]

Each argument is a version of ``csrc/flash_fwd.cu`` (the C interface of
``flash_fwd``) or, all of them, of ``csrc/flash_bwd.cu`` (``flash_bwd_dq``
and ``flash_bwd_dkv``).  All are built with nvcc at once into a temporary
directory (``csrc`` on the include path) and loaded with ctypes; ptxas's
registers and spills of each tensor-core entry are printed.  Every version
runs bf16 cases of several sizes, and the max |error| against
``attention_ref`` (O) or ``attention_bwd_ref`` (dQ, dK, dV) is printed with
whether two launches on the same inputs are bitwise equal.  At the main
path's shapes each version is also timed with CUDA events, in turns (A B ...
B A), beside SDPA (its forward, or the backward of its autograd graph).
One JSON line per case.  Needs a CUDA card; the kernel wrapper's checks and
counters are bypassed, so this is a tool for comparing kernel designs, not
a path of the port.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import NVCC_FLAGS, _nvcc
from repro_torch.kernels.flash_attention.kernel import CSRC
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref,
                                                     row_delta)

# the backward's tolerance against the plain version (chip_smoke.py)
BWD_TOL = 2e-4
# name: B, Sq, Sk, H, Kh, hd, causal, window, timed
CASES = {
    "sq17": (2, 17, 17, 32, 8, 64, True, None, False),
    "ragged1000": (2, 1000, 1000, 32, 8, 64, True, None, False),
    "cross": (1, 64, 192, 4, 4, 64, False, None, False),
    "win100": (1, 700, 700, 4, 2, 64, True, 100, False),
    "hd128": (1, 520, 520, 16, 16, 128, True, None, False),
    "granite": (8, 2048, 2048, 32, 8, 64, True, None, True),
    "stablelm": (8, 2048, 2048, 32, 32, 64, True, None, True),
    "mha128": (2, 1024, 1024, 16, 16, 128, True, None, True),
    "window512": (2, 2048, 2048, 32, 8, 64, True, 512, True),
    "granite_nc": (8, 2048, 2048, 32, 8, 64, False, None, True),
    "hd128_8k": (1, 8192, 8192, 16, 16, 128, True, None, True),
}


def is_bwd(src) -> bool:
    return "int flash_bwd_dq(" in Path(src).read_text()


def build(sources, out_dir):
    """nvcc for every source at once; returns {source: ctypes library}."""
    procs = []
    for i, src in enumerate(sources):
        lib = Path(out_dir) / f"v{i}.so"
        procs.append((src, lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-o",
             str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        # ptxas reports each entry's registers, then its spills
        lines = log.splitlines()
        tc = [ln.split("'")[1] + ": " + lines[i + 2].strip() + " "
              + lines[i + 3].strip()
              for i, ln in enumerate(lines[:-3])
              if "Compiling entry" in ln and "_wgmma" in ln]
        print(json.dumps({"source": src, "tensor_core_ptxas": tc,
                          "warnings": [ln for ln in lines
                                       if "warning" in ln.lower()][:8]}))
        cdll = ctypes.CDLL(str(lib))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if is_bwd(src):
            cdll.flash_bwd_dq.argtypes = [p] * 7 + [i] * 7 + [p, i, i, f, p]
            cdll.flash_bwd_dq.restype = i
            cdll.flash_bwd_dkv.argtypes = [p] * 8 + [i] * 7 + [p, i, i, f, p]
            cdll.flash_bwd_dkv.restype = i
        else:
            cdll.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p,
                                       i, i, f, p]
            cdll.flash_fwd.restype = i
        libs[src] = cdll
    return libs


def call(lib, q, k, v, causal, window):
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    st = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                               *v.stride()[:3], *out.stride()[:3])
    code = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), 1, B, H, Kh, Sq, Sk,
                         hd, ctypes.cast(st, ctypes.c_void_p), int(causal),
                         window or 0, 1.0 / hd ** 0.5,
                         torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"flash_fwd returned {code}")
    return out, lse


def call_bwd(lib, q, k, v, do, lse, delta, causal, window, what):
    """K2 (``what`` "dq": returns (dq,)) or K3 ("dkv": (dk, dv))."""
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    st = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                               *v.stride()[:3], *do.stride()[:3])
    tail = (1, B, H, Kh, Sq, Sk, hd, ctypes.cast(st, ctypes.c_void_p),
            int(causal), window or 0, 1.0 / hd ** 0.5,
            torch.cuda.current_stream().cuda_stream)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    if what == "dq":
        outs = (torch.empty(q.shape, device=q.device),)
        code = lib.flash_bwd_dq(*head, outs[0].data_ptr(), *tail)
    else:
        outs = tuple(torch.empty(k.shape, device=q.device) for _ in range(2))
        code = lib.flash_bwd_dkv(*head, *(o.data_ptr() for o in outs), *tail)
    if code:
        raise RuntimeError(f"flash_bwd_{what} returned {code}")
    return outs


def cuda_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fwd_case(libs, q, k, v, causal, window, timed):
    ref_o, _ = attention_ref(q, k, v, causal=causal, window=window)
    rec = {}
    for src, lib in libs.items():
        o, lse = call(lib, q, k, v, causal, window)
        o2, lse2 = call(lib, q, k, v, causal, window)
        rec[src] = {
            "err_o": (o.float() - ref_o.float()).abs().max().item(),
            "bitwise": bool(torch.equal(o, o2) and torch.equal(lse, lse2))}
    if timed:
        for src in list(libs) + list(libs)[::-1]:
            rec[src].setdefault("ms", []).append(cuda_ms(
                lambda: call(libs[src], q, k, v, causal, window)))
        if window is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rec["sdpa_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
    return rec


def bwd_case(libs, q, k, v, causal, window, timed):
    do = torch.randn(q.shape, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda").bfloat16()
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    delta = row_delta(out, do)
    want = attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                             window=window)
    torch.cuda.empty_cache()
    args = (q, k, v, do, lse, delta, causal, window)
    rec = {}
    for src, lib in libs.items():
        got = call_bwd(lib, *args, "dq") + call_bwd(lib, *args, "dkv")
        again = call_bwd(lib, *args, "dq") + call_bwd(lib, *args, "dkv")
        rec[src] = {
            "err": {n: (g - w).abs().max().item()
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)},
            # largest |error| / (BWD_TOL + BWD_TOL |plain|): <= 1 passes
            "tol_ratio": {n: ((g - w).abs() / (BWD_TOL * (1 + w.abs())))
                          .max().item()
                          for n, g, w in zip(("dq", "dk", "dv"), got, want)},
            "bitwise": all(torch.equal(a, b) for a, b in zip(got, again))}
    del want
    torch.cuda.empty_cache()
    if timed:
        for src in list(libs) + list(libs)[::-1]:
            for what in ("dq", "dkv"):
                rec[src].setdefault(f"{what}_ms", []).append(cuda_ms(
                    lambda: call_bwd(libs[src], *args, what), reps=10))
        if window is None:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True)
            dot = do.transpose(1, 2)
            rec["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                o, (qt, kt, vt), dot, retain_graph=True), reps=10)
    return rec


def main(sources) -> int:
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 1
    kinds = {is_bwd(src) for src in sources}
    if len(kinds) != 1:
        print("compare: give versions of one kernel, all forward or all "
              "backward", file=sys.stderr)
        return 2
    run_case = bwd_case if kinds.pop() else fwd_case
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name, (B, Sq, Sk, H, Kh, hd, causal, window,
                   timed) in CASES.items():
            gen = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .bfloat16() for shape in ((B, Sq, H, hd),
                                                 (B, Sk, Kh, hd),
                                                 (B, Sk, Kh, hd)))
            rec = {"case": name, **run_case(libs, q, k, v, causal, window,
                                            timed)}
            print(json.dumps(rec), flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Hold builds of the SSD chunk scan (K4) against each other on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_scan.compare \\
        A.cu [B.cu ...]

Each argument is a version of ``csrc/ssd_scan.cu`` (the C interface of
``ssd_scan``).  All are built with nvcc at once into a temporary directory
and loaded with ctypes; ptxas's registers and spills of each tensor-core
entry are printed.  Every version runs, in bf16 on its tensor-core route,
the shapes of ``chip_smoke.py``'s phase 8 (``SHAPES``) and the edge cases
of the route (``EDGES``), with x, B and C as strided views of one buffer
(as the mixer hands them over).  For each, the largest ratio of |error| to
phase 8's bf16 tolerance (y: 2e-2 + 2e-2 |y|; h_final: 3e-5 max |h| + 1e-4
|h|) against ``ssd_chunked_ref`` is printed with whether two launches on
the same inputs are bitwise equal.  At phase 8's shapes each version is
also timed with CUDA events, in turns (A B ... B A), beside the least time
the card could take (``chip_smoke.py::ssd_bound``'s count).  One JSON line
per case, after one with the card's name and power limit.  Needs a CUDA
card; the kernel wrapper's checks and counters are bypassed, so this is a
tool for comparing kernel designs, not a path of the port.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels.common import NVCC_FLAGS, _nvcc
from repro_torch.kernels.ssd_scan.meta import kernel_flops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

# name: Bs, S, nh, hp, g, N, Q -- phase 8's bf16 shapes (chip_smoke.py,
# SSD_SHAPES), timed
SHAPES = {
    "mamba2_prefill": (8, 2048, 80, 64, 1, 128, 256),
    "ragged_s1000": (2, 1000, 80, 64, 1, 128, 256),
    "jamba_widths": (1, 1024, 128, 128, 8, 128, 256),
    "jamba_cut_prefill": (8, 2048, 64, 128, 8, 128, 256),
    "jamba_cut_ragged_s1000": (2, 1000, 64, 128, 8, 128, 256),
    "chunk64_s4096": (1, 4096, 80, 64, 1, 128, 64),
    "mamba2_prefill_32k": (2, 32768, 80, 64, 1, 128, 256),
}
# the route's edges, checked only: N below and across a 64-column box,
# hp 128 with g 8, ragged tails inside a box, chunks that are not a
# multiple of 64 or shorter than a tile, the longest chunk, one row
EDGES = {
    "n16": (2, 300, 8, 64, 2, 16, 256),
    "n48_ragged": (1, 333, 4, 64, 1, 48, 128),
    "n80": (1, 300, 4, 64, 1, 80, 256),
    "hp128_g8": (2, 520, 16, 128, 8, 128, 256),
    "q100": (1, 450, 4, 64, 1, 64, 100),
    "q32": (2, 200, 4, 128, 2, 128, 32),
    "q1024": (1, 2100, 4, 128, 1, 128, 1024),
    "s1": (1, 1, 4, 64, 1, 128, 256),
}
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12   # H100 SXM, bf16 dense; HBM3
Y_TOL, H_TOL = (2e-2, 2e-2), (3e-5, 1e-4)


def build(sources, out_dir):
    """nvcc for every source at once; returns {source: ctypes library}."""
    procs = []
    for i, src in enumerate(sources):
        lib = Path(out_dir) / f"v{i}.so"
        procs.append((src, lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for src, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        lines = log.splitlines()
        tc = [ln.split("'")[1] + ": " + " ".join(
                  r.strip() for r in lines[i + 1:i + 5]
                  if "spill" in r or "Used" in r)
              for i, ln in enumerate(lines)
              if "Compiling entry" in ln and "ssd_scan_" in ln
              and "ssd_scan_kernel" not in ln]
        # performance advisories (C75xx: wgmma serialized, warpgroup
        # waits injected) are "ptxas info" lines
        print(json.dumps({"source": src, "tensor_core_ptxas": tc,
                          "warnings": [ln for ln in lines
                                       if "warning" in ln.lower()
                                       or "C75" in ln][:8]}),
              flush=True)
        cdll = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        cdll.ssd_scan.argtypes = [p] * 7 + [i] * 8 + [p, p]
        cdll.ssd_scan.restype = i
        libs[src] = cdll
    return libs


def inputs(case, gen):
    Bs, S, nh, hp, g, N, _ = case
    buf = torch.randn((Bs, S, nh * hp + 2 * g * N), generator=gen,
                      device="cuda").to(torch.bfloat16)
    x = buf[..., :nh * hp].reshape(Bs, S, nh, hp)
    B = buf[..., nh * hp:nh * hp + g * N].reshape(Bs, S, g, N)
    C = buf[..., nh * hp + g * N:].reshape(Bs, S, g, N)
    dt = torch.nn.functional.softplus(torch.randn((Bs, S, nh), generator=gen,
                                                  device="cuda"))
    A = -torch.exp(0.3 * torch.randn(nh, generator=gen, device="cuda"))
    return x, dt, A, B, C


def call(lib, x, dt, A, B, C, Q):
    Bs, S, nh, hp = x.shape
    g, N = B.shape[2], B.shape[3]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    h = torch.empty((Bs, nh, hp, N), dtype=torch.float32, device=x.device)
    st = (ctypes.c_int64 * 12)(*x.stride()[:3], *dt.stride(),
                               *B.stride()[:3], *C.stride()[:3])
    code = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), C.data_ptr(), y.data_ptr(),
                        h.data_ptr(), 1, Bs, S, nh, hp, g, N, min(Q, S),
                        ctypes.cast(st, ctypes.c_void_p),
                        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"ssd_scan returned {code}")
    return y, h


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(case):
    """The least time (ms): operations over the bf16 peak or bytes (x, dt,
    A, B and C read once, y and the f32 h_final written once) over HBM
    bandwidth, the larger; and which of the two."""
    Bs, S, nh, hp, g, N, Q = case
    flops = kernel_flops((Bs, S, nh, hp), (Bs, S, g, N), Q)
    nbytes = (2 * Bs * S * nh * hp * 2 + 4 * Bs * S * nh + 4 * nh
              + 2 * Bs * S * g * N * 2 + 4 * Bs * nh * hp * N)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def ratio(got, want, tol, scaled):
    atol = tol[0] * want.abs().max().item() if scaled else tol[0]
    return ((got - want).abs() / (atol + tol[1] * want.abs())).max().item()


def run_case(libs, name, case, timed, gen):
    x, dt, A, B, C = inputs(case, gen)
    Q = case[-1]
    yr, hr = ssd_chunked_ref(x, dt, A, B, C, Q)
    rec = {"case": name, "dims": list(case)}
    for src, lib in libs.items():
        y, h = call(lib, x, dt, A, B, C, Q)
        y2, h2 = call(lib, x, dt, A, B, C, Q)
        torch.cuda.synchronize()
        rec[src] = {
            "ratio_y": ratio(y.float(), yr.float(), Y_TOL, False),
            "ratio_h": ratio(h, hr, H_TOL, True),
            "finite": bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
            "bitwise": bool(torch.equal(y, y2) and torch.equal(h, h2))}
        del y, h, y2, h2
    del yr, hr
    if timed:
        for src in list(libs) + list(libs)[::-1]:
            rec[src].setdefault("ms", []).append(cuda_ms(
                lambda: call(libs[src], x, dt, A, B, C, Q)))
        ms, by, flops = bound_ms(case)
        rec.update(bound_ms=ms, bound_by=by, flops=flops)
        for src in libs:
            best = min(rec[src]["ms"])
            rec[src]["tflops"] = flops / best / 1e9
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()


def main(argv):
    if not argv:
        raise SystemExit(__doc__)
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(argv, tmp)
        gen = torch.Generator(device="cuda").manual_seed(4)
        for name, case in EDGES.items():
            run_case(libs, name, case, False, gen)
        for name, case in SHAPES.items():
            run_case(libs, name, case, True, gen)


if __name__ == "__main__":
    main(sys.argv[1:])

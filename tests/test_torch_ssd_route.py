"""K4's (the SSD chunk scan's) route table on the CPU, and the arithmetic of
its tensor-core route.

* Which (dtype, head_dim, d_state) inputs K4 sends to the tensor-core kernel
  (bf16 at hp 64 and 128 with N a multiple of 16 up to 128), that
  ``ssd_scan.cu`` dispatches on the same table and exports it, that the
  wrapper counts launches by route, and that the CPU path launches nothing;
  the tensor-core kernel's shared memory (``tc::Layout``) and its build key.
* The tensor-core kernel's arithmetic, emulated here: G = C B^T multiplies
  bf16 inputs exactly and sums in f32; M = G exp(la_i - la_j) dt_j, C h^T's
  h and the state update's w B (w_j = exp(la_last - la_j) dt_j) are each
  split into bf16 hi + lo parts, both multiplied, summed in f32; each 64-row
  tile's state product is added to h by f32 adds.  That stays within phase
  8's tolerance (``SSD_TOL`` in chip_smoke.py: y 2e-2, h_final 3e-5 of
  max |h|) of the JAX package's Pallas scan (interpret mode), where w B
  rounded straight to bf16 misses h's, and M rounded straight to bf16 misses
  y's.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as K  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

# phase 8's tolerances for bf16 (chip_smoke.py, SSD_TOL): y (atol, rtol)
# fixed; h_final atol 3e-5 of the reference's largest |h|, rtol 1e-4
Y_TOL = (2e-2, 2e-2)
H_TOL = (3e-5, 1e-4)
TILE = 64   # rows of a column tile of the state update


@pytest.mark.parametrize("N", [8, 16, 24, 64, 128, 144])
@pytest.mark.parametrize("hp", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_route_table(dtype, hp, N):
    dtype = getattr(torch, dtype)
    want = ("tensor_core" if dtype == torch.bfloat16 and hp in (64, 128)
            and N % 16 == 0 and N <= 128 else "cuda_core")
    assert K.route(dtype, hp, N) == want


def test_the_cuda_source_dispatches_on_the_same_table():
    src = Path(K.SOURCE).read_text()
    body = re.search(r"int route_of\(int dtype, int hp, int N\) \{\s*"
                     r"return ([^;]*);", src)
    assert body, "route_of not found in ssd_scan.cu"
    expr = " ".join(body.group(1).split())
    assert "dtype == 1" in expr      # bf16 in ssd_scan's dtype codes
    assert sorted(int(d) for d in re.findall(r"hp == (\d+)", expr)) == \
        sorted(hp for _, hp in K.TENSOR_CORE)
    assert "N % 16 == 0" in expr and "N <= NMAX" in expr
    assert re.search(r"constexpr int NMAX = (\d+);", src).group(1) == \
        str(K.MAX_STATE)
    assert "if (route_of(dtype, hp, N))" in src
    assert "int ssd_scan_route(int dtype, int hp, int N)" in src


@pytest.mark.parametrize("Q", [64, 100, 256, 1024])
def test_the_tensor_core_route_fits_one_block_an_sm_at_every_chunk(Q):
    # a block owns one 64-column slab of a head, so its shared memory is
    # the same at hp 64 and 128 and every N up to 128; it fits a block's
    # 227 KB at the longest chunk taken, and one block fills an SM (Hopper's
    # SM has 228 KB, 1 KB of it reserved per block)
    sizes = {K.smem_bytes(hp, N, Q, "tensor_core")
             for hp in (64, 128) for N in (16, 48, 128)}
    assert len(sizes) == 1
    smem = sizes.pop()
    assert smem <= K.MAX_SMEM
    assert 2 * (smem + 1024) > 228 * 1024
    # mamba2-2.7b's shape (hp 64, N 128, chunk 256): ~207 KB
    assert K.smem_bytes(64, 128, 256, "tensor_core") == 212112


def test_smem_bytes_follows_the_kernels_layout():
    """``kernel.smem_bytes`` of the tensor-core route is
    ``tc::Layout::alloc`` in ssd_scan.cu: its stages, C slots, state boxes
    and barriers, read from the source."""
    src = Path(K.SOURCE).read_text()
    tc = src[src.index("namespace tc {"):]
    stages = int(re.search(r"constexpr int STAGES = (\d+);", tc).group(1))
    assert "static constexpr int STAGE = 3 * TILE;" in tc
    assert "static constexpr int C_OFF = STAGES * STAGE;" in tc
    assert "static constexpr int H_HI = C_OFF + 4 * 2 * TILE;" in tc
    assert "static constexpr int H_F32 = H_LO + NMAX * BOX;" in tc
    assert "static constexpr int LA = H_F32 + NMAX * TR * 4;" in tc
    assert "return LA + 2 * 3 * qr(Q) * 4;" in tc
    bars = re.search(r"N_BARS = 2 \* STAGES \+ 4 \+ 4 \+ 2 \+ 2;", tc)
    assert bars and "return bars(Q) + 8 * N_BARS + 1024;" in tc
    box, nmax = 64 * 128, K.MAX_STATE
    for Q in (1, 64, 256, 1000):
        qr = -(-Q // 64) * 64
        want = (stages * 3 * box + 4 * 2 * box + 2 * nmax * 128
                + nmax * 64 * 4 + 2 * 3 * qr * 4
                + 8 * (2 * stages + 12) + 1024)
        assert K.smem_bytes(64, 128, Q, "tensor_core") == want


def test_the_build_key_covers_the_shared_hopper_header():
    # ssd_scan.cu includes the flash kernels' Hopper building blocks
    from repro_torch.kernels.common import _included
    seen = set()
    _included(Path(K.SOURCE), seen)
    assert {p.name for p in seen} == {"ssd_scan.cu", "hopper.cuh"}


def _inputs(case, seed=0):
    Bs, S, nh, hp, g, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bs, S, nh, hp), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((Bs, S, nh)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    B = rng.standard_normal((Bs, S, g, N), dtype=np.float32)
    C = rng.standard_normal((Bs, S, g, N), dtype=np.float32)
    return x, dt, A, B, C


def test_the_wrapper_counts_by_route_and_the_cpu_launches_nothing():
    assert set(K.ssd_scan_kernel.launches_by_route) == set(K.ROUTES)
    x, dt, A, B, C = _inputs((1, 40, 4, 64, 1, 128, 16))
    before = (K.ssd_scan_kernel.launches,
              dict(K.ssd_scan_kernel.launches_by_route))
    y, h = ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                    chunk=16, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert (K.ssd_scan_kernel.launches,
            dict(K.ssd_scan_kernel.launches_by_route)) == before


# ------------------------------------------- the tensor-core arithmetic
def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    """bf16 hi and lo parts of an f32 tensor, as f32."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _emulated(x, dt, A, B, C, Q, *, split_m=True, split_wb=True):
    """The tensor-core route's arithmetic on bf16 x, B, C (as f32 tensors
    holding bf16 values) and f32 dt, A.  Returns y rounded to bf16 and the
    f32 final state."""
    Bs, S, nh, hp = x.shape
    rep = nh // B.shape[2]
    parts_m = _split if split_m else lambda t: (_bf16(t),)
    parts_wb = _split if split_wb else lambda t: (_bf16(t),)
    Bh = B.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2)
    h = torch.zeros((Bs, nh, hp, B.shape[3]))
    ys = []
    for c0 in range(0, S, Q):
        sl = slice(c0, min(c0 + Q, S))
        xc, dtc, Bc, Cc = x[:, sl], dt[:, sl], Bh[:, sl], Ch[:, sl]
        Qc = xc.shape[1]
        la = torch.cumsum(dtc * A, dim=1)                    # (Bs, Qc, nh)
        G = torch.einsum("bihn,bjhn->bhij", Cc, Bc)      # exact, f32 sums
        lah = la.permute(0, 2, 1)                           # (Bs, nh, Qc)
        tri = torch.ones((Qc, Qc), dtype=torch.bool).tril()
        diff = (lah[..., :, None] - lah[..., None, :]).masked_fill(
            ~tri, float("-inf"))
        M = G * torch.exp(diff) * dtc.permute(0, 2, 1)[:, :, None, :]
        y = sum(torch.einsum("bhij,bjhp->bihp", m, xc) for m in parts_m(M))
        inter = sum(torch.einsum("bihn,bhpn->bihp", Cc, p)
                    for p in _split(h))
        ys.append(y + inter * torch.exp(la)[..., None])
        la_last = la[:, -1]                                  # (Bs, nh)
        w = torch.exp(la_last[:, None] - la) * dtc           # (Bs, Qc, nh)
        wB = parts_wb(Bc * w[..., None])
        h = torch.exp(la_last)[..., None, None] * h
        for t0 in range(0, Qc, TILE):                        # f32 adds
            ts = slice(t0, t0 + TILE)
            h = h + sum(torch.einsum("bjhp,bjhn->bhpn", xc[:, ts], p[:, ts])
                        for p in wB)
    return _bf16(torch.cat(ys, dim=1)), h


def _ratios(got, want):
    """Largest |err| / allowed of y and of h under phase 8's bf16
    tolerances: <= 1 passes."""
    (y, h), (yr, hr) = got, want
    ry = (y - yr).abs() / (Y_TOL[0] + Y_TOL[1] * yr.abs())
    rh = (h - hr).abs() / (H_TOL[0] * hr.abs().max() + H_TOL[1] * hr.abs())
    return ry.max().item(), rh.max().item()


@pytest.mark.parametrize("case", [
    # Bs, S, nh, hp, g, N, Q
    (2, 300, 4, 64, 1, 128, 256),    # a ragged second chunk
    (1, 512, 4, 64, 2, 128, 64),     # g 2, eight chunks
])
def test_hi_lo_splits_hold_phase_8s_tolerance(case):
    Bs, S, nh, hp, g, N, Q = case
    x, dt, A, B, C = _inputs(case)
    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, B, C))
    yj, hj = jax_ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                          chunk=Q, head_block=nh, interpret=True,
                          return_state=True)
    want = (torch.from_numpy(np.array(yj.astype(jnp.float32))),
            torch.from_numpy(np.array(hj)))
    ins = [_bf16(torch.from_numpy(x)), torch.from_numpy(dt),
           torch.from_numpy(A), _bf16(torch.from_numpy(B)),
           _bf16(torch.from_numpy(C))]
    ry, rh = _ratios(_emulated(*ins, Q), want)
    assert ry <= 1.0 and rh <= 1.0, (ry, rh)
    # w B rounded straight to bf16: h_final misses its f32 tolerance
    assert _ratios(_emulated(*ins, Q, split_wb=False), want)[1] > 1.0
    # M rounded straight to bf16: y misses its tolerance where cancellation
    # leaves it small (M is not normalised, unlike softmax's P)
    assert _ratios(_emulated(*ins, Q, split_m=False), want)[0] > 1.0

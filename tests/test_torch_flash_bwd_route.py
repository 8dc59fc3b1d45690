"""The flash-attention backward's route table on the CPU, and the arithmetic
of its tensor-core route.

* Which (dtype, head_dim) pairs K2 (dQ) and K3 (dK/dV) send to the
  tensor-core kernels (the forward's table: bf16 at hd 64, 80 and 128),
  that ``flash_bwd.cu`` dispatches on the same table and has a kernel
  of each of its widths, that both wrappers count launches by route and
  that the CPU path launches nothing.
* The tensor-core kernels' arithmetic, emulated here: S = Q K^T and dP =
  dO V^T multiply bf16 inputs exactly and sum in f32; P and dS are split
  into bf16 hi + bf16 lo parts, both multiplied, summed in f32.  That
  stays within the backward's tolerance (``BWD_TOL``, 2e-4) of the JAX
  package's Pallas backward (interpret mode), where rounding P and dS
  straight to bf16 does not.
* The build key of a kernel library covers the headers its source
  includes (both flash sources include ``csrc/hopper.cuh``), so a changed
  header never loads a stale library.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_bwd_kernel as pallas_bwd  # noqa: E402
from repro.kernels.flash_attention.ops import _layout  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask, attention_ref, row_delta)

HEAD_DIMS = list(range(16, 257, 16))
BWD = (fa.flash_attention_bwd_dq_kernel, fa.flash_attention_bwd_dkv_kernel)
# K2/K3 against the plain backward on the card (chip_smoke.py and
# tests/test_torch_cuda.py): the same f32 tolerance
BWD_TOL = 2e-4


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_routes_as_the_forward(dtype, hd):
    # the forward's table: bf16 at hd 64, 80 and 128 on the tensor cores;
    # f32 never (TF32 would break the f32 tolerance)
    dtype = getattr(torch, dtype)
    want = ("tensor_core" if dtype == torch.bfloat16 and hd in (64, 80, 128)
            else "cuda_core")
    assert fa.route(dtype, hd) == want


def test_the_cuda_source_dispatches_on_the_same_table():
    src = Path(fa.BWD_SOURCE).read_text()
    body = re.search(r"int route_of\(int dtype, int hd\) \{\s*return ([^;]*);",
                     src)
    assert body, "route_of not found in flash_bwd.cu"
    expr = body.group(1)
    assert "dtype == 1" in expr      # bf16 in flash_bwd's dtype codes
    assert sorted(int(d) for d in re.findall(r"hd == (\d+)", expr)) == \
        sorted(hd for dt, hd in fa.TENSOR_CORE)
    # both kernels dispatch through it, and the library exports it
    assert "if (route_of(dtype, hd)) return tc::launch<DQ>(hd, a);" in src
    assert "int flash_bwd_route(int dtype, int hd)" in src
    # tc::launch names an instantiation of every hd of the table and
    # refuses any other: no hd reaches a kernel of another width
    launch = re.search(r"int launch\(int hd, const Args& a\) \{(.*?)\n\}",
                       src, re.S)
    assert launch, "tc::launch not found in flash_bwd.cu"
    cases = re.findall(r"case (\d+): return DQ \? launch_dq<(\d+)>\(a\) : "
                       r"launch_dkv<(\d+)>\(a\);", launch.group(1))
    assert all(a == b == c for a, b, c in cases)
    assert sorted(int(a) for a, _, _ in cases) == \
        sorted(hd for _, hd in fa.TENSOR_CORE)
    assert launch.group(1).rstrip().endswith(
        "default: return cudaErrorInvalidValue;\n  }")


def test_both_backward_kernels_count_launches_by_route():
    for fn in BWD:
        assert set(fn.launches_by_route) == set(fa.ROUTES)


def test_the_cpu_backward_launches_no_kernel():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 40, 4, 64), dtype=np.float32)).to(torch.bfloat16)
        .requires_grad_(True) for _ in range(3))
    before = [(fn.launches, dict(fn.launches_by_route)) for fn in BWD]
    grads = torch.autograd.grad(
        flash_attention(q, k, v, causal=True).float().square().sum(),
        (q, k, v))
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all()
               for g in grads)
    assert [(fn.launches, dict(fn.launches_by_route)) for fn in BWD] == before


# ------------------------------------------- the tensor-core arithmetic
def _split(x):
    """bf16 hi and lo parts of an f32 tensor, as f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulated_bwd(q, k, v, do, lse, delta, *, causal, window, split):
    """The tensor-core route's arithmetic on (B, S, H, hd) bf16 inputs with
    H == Kh: exact S and dP (bf16 products summed in f32), P = exp(S scale
    - L) masked to 0, dS = P (dP - D), and P and dS either split into bf16
    hi + lo (``split``) or rounded to bf16, each part multiplied and summed
    in f32.  Returns f32 dq, dk, dv."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / hd ** 0.5

    def heads(x):                                   # -> (B, H, S, hd) f32
        return x.float().permute(0, 2, 1, 3)
    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(do)
    s = qh @ kh.transpose(-1, -2)
    mask = attention_mask(Sq, Sk, causal=causal, window=window)
    p = torch.where(mask, torch.exp(s * scale - lse.reshape(B, H, Sq, 1)),
                    0.0)
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - delta.reshape(B, H, Sq, 1))
    parts = (_split if split else
             lambda x: (x.to(torch.bfloat16).float(),))
    pp, dsp = parts(p), parts(ds)
    dq = sum(x @ kh for x in dsp) * scale
    dk = sum(x.transpose(-1, -2) @ qh for x in dsp) * scale
    dv = sum(x.transpose(-1, -2) @ doh for x in pp)
    return tuple(g.permute(0, 2, 1, 3) for g in (dq, dk, dv))


def _pallas_bwd(q, k, v, do, out, lse, *, causal, window, block):
    """The JAX package's Pallas backward in interpret mode on
    ``_layout``-padded inputs (as tests/test_torch_flash_attention_bwd.py
    runs it), H == Kh; returns numpy dq, dk, dv in (B, S, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    jq, jk, jv, jdo, jout = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                             for x in (q, k, v, do, out))
    qf, kf, vf, geom = _layout(jq, jk, jv, block, block)
    bq, bk = geom[6], geom[7]
    sq_pad = -(-Sq // bq) * bq

    def padded(x):
        xf = jnp.moveaxis(x, 2, 1).reshape(B * H, Sq, hd)
        return jnp.pad(xf, ((0, 0), (0, sq_pad - Sq), (0, 0)))

    gf = padded(jdo)
    delta = jnp.sum(gf.astype(jnp.float32) * padded(jout).astype(jnp.float32),
                    axis=-1)
    jlse = jnp.pad(jnp.asarray(lse.numpy()), ((0, 0), (0, sq_pad - Sq)))
    dqf, dkf, dvf = pallas_bwd(qf, kf, vf, gf, jlse, delta, causal=causal,
                               window=window, sk=Sk, block_q=bq, block_k=bk,
                               interpret=True)
    return (np.moveaxis(np.asarray(dqf[:, :Sq]).reshape(B, H, Sq, hd), 1, 2),
            np.moveaxis(np.asarray(dkf[:, :Sk]).reshape(B, H, Sk, hd), 1, 2),
            np.moveaxis(np.asarray(dvf[:, :Sk]).reshape(B, H, Sk, hd), 1, 2))


def _ratio(got, want):
    """Largest |got - want| / (BWD_TOL + BWD_TOL |want|): <= 1 passes."""
    return max(float(np.max(np.abs(g.numpy() - w)
                            / (BWD_TOL + BWD_TOL * np.abs(w))))
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", [
    # B, S, H, hd, causal, window
    (1, 256, 2, 64, True, None),
    (1, 200, 2, 128, True, 64),
    (1, 256, 2, 80, False, None),
])
def test_hi_lo_split_holds_the_f32_tolerance(case):
    B, S, H, hd, causal, window = case
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, S, H, hd), dtype=np.float32)).to(torch.bfloat16)
        for _ in range(4))
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    delta = row_delta(out, do)
    want = _pallas_bwd(q, k, v, do, out, lse, causal=causal, window=window,
                       block=64)
    mask = dict(causal=causal, window=window)
    split = _emulated_bwd(q, k, v, do, lse, delta, split=True, **mask)
    for g, w in zip(split, want):
        np.testing.assert_allclose(g.numpy(), w, atol=BWD_TOL, rtol=BWD_TOL)
    # P and dS rounded straight to bf16 stray past the tolerance already at
    # this length (13-18x at S 2048)
    rounded = _emulated_bwd(q, k, v, do, lse, delta, split=False, **mask)
    assert _ratio(split, want) < 0.1
    assert _ratio(rounded, want) > 1.0


# ------------------------------------------------------------ the build key
def test_the_build_key_covers_every_included_header(tmp_path):
    from repro_torch.kernels.common import library_key
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n')
    key = library_key(src)
    assert library_key(src) == key
    # a header two includes deep changes the key, as does the source
    (tmp_path / "inner.cuh").write_text("// v2\n")
    key2 = library_key(src)
    assert key2 != key
    src.write_text(src.read_text() + "// touched\n")
    assert library_key(src) not in (key, key2)


def test_both_flash_sources_share_the_hopper_header():
    from repro_torch.kernels.common import _included
    for source in (fa.SOURCE, fa.BWD_SOURCE):
        seen = set()
        _included(Path(source), seen)
        assert {p.name for p in seen} == {Path(source).name, "hopper.cuh"}

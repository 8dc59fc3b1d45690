"""The port's flash-attention backward against the JAX package.

* The plain backward (``ref.attention_bwd_ref``, what K2/K3 compute) against
  the reference's Pallas backward kernels run in interpret mode on
  ``_layout``-padded inputs, with the reference's GQA sum applied.
* The port's differentiable ``ops.flash_attention`` (its
  ``autograd.Function`` on CPU tensors) against ``jax.grad`` of the
  reference's ``flash_attention(..., interpret=True)``, and against
  ``torch.autograd`` of the plain ``models.layers.naive_attention``.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: f32 2e-5 (only the order of the f32 sums differs); bf16 2e-2
(the gradients are rounded to bf16 at the end, ~4e-3 relative, on values
of order 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_bwd_kernel as pallas_bwd  # noqa: E402
from repro.kernels.flash_attention.ops import _layout  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref, row_delta)
from repro_torch.models.layers import naive_attention  # noqa: E402

# a subset of tests/test_kernels.py FLASH_CASES: GQA, padding, cross-length,
# window + odd sizes
CASES = [
    # B, Sq, Sk, H, Kh, hd, causal, window, bq, bk
    (2, 128, 128, 4, 2, 64, True, None, 64, 64),
    (2, 100, 100, 4, 1, 64, False, None, 32, 32),
    (1, 64, 192, 2, 2, 16, False, None, 64, 64),
    (3, 80, 80, 6, 3, 48, True, 32, 16, 16),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(case, dtype, seed=0):
    """q, k, v, do as torch tensors of ``dtype`` and the same values as
    jnp arrays."""
    B, Sq, Sk, H, Kh, hd = case[:6]
    rng = np.random.default_rng(seed)
    shapes = [(B, Sq, H, hd), (B, Sk, Kh, hd), (B, Sk, Kh, hd), (B, Sq, H, hd)]
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    jj = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    return tt, jj


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, tol, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=tol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_interpret(case, dtype):
    B, Sq, Sk, H, Kh, hd, causal, window, bq, bk = case
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(case, dtype)
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    got = attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                            window=window)
    assert all(g.dtype == torch.float32 for g in got)

    # the reference's _flash_bwd around its Pallas kernels, on the same
    # out and lse
    qf, kf, vf, geom = _layout(jq, jk, jv, bq, bk)
    bq, bk = geom[6], geom[7]
    sq_pad = -(-Sq // bq) * bq

    def padded(x):
        xf = jnp.moveaxis(x, 2, 1).reshape(B * H, Sq, hd)
        return jnp.pad(xf, ((0, 0), (0, sq_pad - Sq), (0, 0)))

    gf = padded(jdo)
    jout = jnp.asarray(_f32(out), getattr(jnp, dtype))
    delta = jnp.sum(gf.astype(jnp.float32) * padded(jout).astype(jnp.float32),
                    axis=-1)
    jlse = jnp.pad(jnp.asarray(lse.numpy()), ((0, 0), (0, sq_pad - Sq)))
    dqf, dkf, dvf = pallas_bwd(qf, kf, vf, gf, jlse, delta, causal=causal,
                               window=window, sk=Sk, block_q=bq, block_k=bk,
                               interpret=True)
    rep = H // Kh
    want = (jnp.moveaxis(dqf[:, :Sq].reshape(B, H, Sq, hd), 1, 2),
            jnp.moveaxis(dkf[:, :Sk].reshape(B, Kh, rep, Sk, hd).sum(2), 1, 2),
            jnp.moveaxis(dvf[:, :Sk].reshape(B, Kh, rep, Sk, hd).sum(2), 1, 2))
    _assert_close(got, want, TOL[dtype], "plain vs pallas")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_grads_match_jax_and_plain(case, dtype):
    causal, window, bq, bk = case[6:]
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(case, dtype, seed=1)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(
        flash_attention(q, k, v, causal=causal, window=window), (q, k, v), do)
    assert [g.dtype for g in got] == [q.dtype] * 3

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=bq, block_k=bk, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    _assert_close(got, want, TOL[dtype], "function vs jax.grad(pallas)")

    plain = torch.autograd.grad(
        naive_attention(q, k, v, causal=causal, window=window), (q, k, v), do)
    _assert_close(got, plain, TOL[dtype], "function vs naive autograd")


def test_row_delta_is_rowsum_of_do_times_out():
    rng = np.random.default_rng(2)
    out = torch.from_numpy(rng.standard_normal((2, 5, 3, 8), np.float32))
    do = torch.from_numpy(rng.standard_normal((2, 5, 3, 8), np.float32))
    d = row_delta(out, do)
    assert d.shape == (6, 5) and d.is_contiguous()
    want = (out * do).sum(-1).permute(0, 2, 1).reshape(6, 5)
    torch.testing.assert_close(d, want)

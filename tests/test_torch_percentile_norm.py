"""The port's percentile stretch (``repro_torch.kernels.percentile_norm``)
against the JAX package on the same numpy inputs: its plain version
against the reference's ``percentile_normalize`` (Pallas in interpret
mode) and its oracle ``percentile_normalize_ref``; the percentile helper
against ``np.percentile`` above ``torch.quantile``'s 2**24-element limit;
and the gradients of the port's ``autograd.Function`` against
``jax.grad``, including the clip subgradient of 0.5 at exact ties.

Tolerances are the reference's own (``tests/test_kernels.py``): forward
atol = rtol = 1e-5; gradients 2e-3 in f32 and 2e-1 in bf16 (the
percentile-neighbour pixels carry the summed dlo/dhi terms).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.percentile_norm import (  # noqa: E402
    percentile_normalize as jax_percentile_normalize)
from repro.kernels.percentile_norm.ref import (  # noqa: E402
    percentile_normalize_ref as jax_percentile_normalize_ref)
from repro_torch.kernels.percentile_norm import (  # noqa: E402
    percentile_normalize)
from repro_torch.kernels.percentile_norm.ref import (  # noqa: E402
    percentile_normalize_ref, percentiles, stretch_ref)

SHAPES = [(64, 64, 3), (100, 37, 13), (257, 3), (31, 31, 1)]
GRAD_SHAPES = [(257, 5), (64, 64, 3), (100, 37, 13)]
GRAD_TOL = {"float32": 2e-3, "bfloat16": 2e-1}


def _img(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.gamma(2.0, 500.0, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(shape):
    img = _img(shape)
    got = percentile_normalize(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_percentile_normalize(jnp.asarray(img),
                                               block_rows=128))
    oracle = np.asarray(jax_percentile_normalize_ref(jnp.asarray(img)))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=1e-5)
    ref = percentile_normalize_ref(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_percentiles_match_jnp(shape):
    flat = _img(shape).reshape(-1, shape[-1])
    got = percentiles(torch.from_numpy(flat), (1.0, 99.0)).numpy()
    for row, q in zip(got, (1.0, 99.0)):
        want = np.asarray(jax.jit(lambda v, q=q: jnp.percentile(
            v, q, axis=0))(jnp.asarray(flat)))
        np.testing.assert_allclose(row, want, rtol=1e-6)


def test_constant_band_stays_finite():
    out = percentile_normalize(torch.ones((64, 64, 2)))
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_percentile_normalize(jnp.ones(
            (64, 64, 2)))))


def test_bf16_input():
    img = _img((100, 37, 4))
    x = torch.from_numpy(img).to(torch.bfloat16)
    got = percentile_normalize(x)
    assert got.dtype == torch.float32
    want = np.asarray(jax_percentile_normalize(
        jnp.asarray(img).astype(jnp.bfloat16), block_rows=128))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_nan_pixel_stays_nan():
    """The stretch keeps a NaN pixel NaN, as ``jnp.clip`` does; a band that
    holds a NaN gets NaN bounds, as ``jnp.percentile`` gives."""
    x = torch.tensor([[0.0, 1.0], [float("nan"), 2.0], [4.0, 3.0]])
    lo, hi = torch.tensor([[1.0, 1.0]]), torch.tensor([[3.0, 3.0]])
    out = stretch_ref(x, lo, hi)
    assert torch.isnan(out[1, 0]) and not torch.isnan(out[0]).any()
    np.testing.assert_array_equal(out[[0, 2]].numpy(),
                                  [[0.0, 0.0], [1.0, 1.0]])
    img = _img((40, 30, 3))
    img[5, 7, 1] = np.nan
    got = percentile_normalize(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_percentile_normalize(jnp.asarray(img)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[..., 1]).all() and not np.isnan(got[..., 0]).any()
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=1e-5)


def test_percentile_helper_above_quantile_limit():
    """(2**22 + 1, 5) holds more than 2**24 elements, which
    ``torch.quantile`` refuses; the helper's sort does not."""
    rng = np.random.default_rng(1)
    flat = rng.gamma(2.0, 500.0, size=(2 ** 22 + 1, 5)).astype(np.float32)
    got = percentiles(torch.from_numpy(flat), (1.0, 99.0)).numpy()
    want = np.percentile(flat, [1.0, 99.0], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _jax_grads(x_np, co_np, jdtype):
    x = jnp.asarray(x_np).astype(jdtype)
    co = jnp.asarray(co_np)
    g = jax.grad(lambda v: jnp.sum(jax_percentile_normalize(
        v, block_rows=64) * co))(x)
    return np.asarray(g.astype(jnp.float32))


@pytest.mark.parametrize("shape", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_jax(shape, dtype):
    rng = np.random.default_rng(2)
    x_np = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    co_np = rng.standard_normal(shape).astype(np.float32)
    want = _jax_grads(x_np, co_np, getattr(jnp, dtype))
    x = torch.from_numpy(x_np).to(getattr(torch, dtype)).requires_grad_(True)
    (percentile_normalize(x) * torch.from_numpy(co_np)).sum().backward()
    assert x.grad.dtype == x.dtype and torch.isfinite(x.grad.float()).all()
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(x.grad.float().numpy(), want, atol=tol,
                               rtol=tol)


def test_tie_gradient_is_half():
    """R = 101 evenly spaced: 0.01 (R - 1) and 0.99 (R - 1) are integers,
    so lo and hi are pixels and ``u == 0`` / ``u == 1`` land exactly on
    them; the clip passes half a gradient there, as in the reference."""
    x_np = np.linspace(-100.0, 100.0, 101, dtype=np.float32).reshape(-1, 1)
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jax_percentile_normalize(v)))(jnp.asarray(x_np)))
    x = torch.from_numpy(x_np).requires_grad_(True)
    percentile_normalize(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-6, rtol=1e-6)
    # the stretch alone: 0.5 s at the two ties, 0 outside, s inside
    flat = torch.from_numpy(x_np)
    pct = percentiles(flat, (1.0, 99.0))
    lo, hi = pct[0:1], pct[1:2]
    s = 1.0 / (hi - lo).item()
    xg = flat.clone().requires_grad_(True)
    from repro_torch.kernels.percentile_norm.ops import _Stretch
    _Stretch.apply(xg, lo, hi, False).sum().backward()
    g = xg.grad[:, 0].numpy()
    assert g[1] == pytest.approx(0.5 * s) and g[99] == pytest.approx(0.5 * s)
    assert g[0] == 0 and g[100] == 0
    np.testing.assert_allclose(g[2:99], s, rtol=1e-6)


def test_cuda_backend_on_a_cpu_tensor_raises():
    with pytest.raises(ValueError, match="CUDA"):
        percentile_normalize(torch.ones((8, 8, 2)), backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        percentile_normalize(torch.ones((8, 8, 2)), backend="pallas")


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.percentile_norm.kernel import (
        percentile_norm_kernel)
    x = torch.ones((8, 2))
    lo, hi = torch.zeros((1, 2)), torch.ones((1, 2))
    n0 = percentile_norm_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        percentile_norm_kernel(x, lo, hi)
    with pytest.raises(ValueError, match="must be"):
        percentile_norm_kernel(x, lo[:, :1], hi)
    with pytest.raises(TypeError):
        percentile_norm_kernel(x.double(), lo, hi)
    assert percentile_norm_kernel.launches == n0

"""The port's plain flash-attention forward (O and LSE) against the JAX
package's Pallas kernel run in interpret mode, and against its oracle.
Inputs are made with numpy from a seed and handed to both frameworks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd_kernel as pallas_fwd  # noqa: E402
from repro.kernels.flash_attention.ops import _layout  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# a subset of tests/test_kernels.py FLASH_CASES: GQA, padding, cross-length,
# window + odd sizes
CASES = [
    # B, Sq, Sk, H, Kh, hd, causal, window, bq, bk
    (2, 128, 128, 4, 2, 64, True, None, 64, 64),
    (2, 100, 100, 4, 1, 64, False, None, 32, 32),
    (1, 64, 192, 2, 2, 16, False, None, 64, 64),
    (3, 80, 80, 6, 3, 48, True, 32, 16, 16),
]
# tests/test_kernels.py tolerances for O; LSE is f32 in both dtypes
TOL = {"float32": (2e-6, 1e-5), "bfloat16": (2e-2, 1e-4)}


def _inputs(case, seed=0):
    B, Sq, Sk, H, Kh, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, Kh, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, Kh, hd), dtype=np.float32))


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pallas(qn, kn, vn, case, dtype):
    B, Sq, Sk, H, Kh, hd, causal, window, bq, bk = case
    q, k, v = (jnp.asarray(x, getattr(jnp, dtype)) for x in (qn, kn, vn))
    qf, kf, vf, geom = _layout(q, k, v, bq, bk)
    out, lse = pallas_fwd(qf, kf, vf, causal=causal, window=window, sq=Sq,
                          sk=Sk, block_q=geom[6], block_k=geom[7],
                          interpret=True)
    out = jnp.moveaxis(out[:, :Sq].reshape(B, H, Sq, hd), 1, 2)
    return _f32(out), _f32(lse[:, :Sq])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(case, dtype):
    causal, window = case[6], case[7]
    qn, kn, vn = _inputs(case)
    out, lse = attention_ref(*(_to_torch(x, dtype) for x in (qn, kn, vn)),
                             causal=causal, window=window)
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    ref_out, ref_lse = _pallas(qn, kn, vn, case, dtype)
    tol_o, tol_l = TOL[dtype]
    np.testing.assert_allclose(_f32(out), ref_out, atol=tol_o, rtol=tol_o)
    np.testing.assert_allclose(_f32(lse), ref_lse, atol=tol_l, rtol=tol_l)

    oracle = jax_attention_ref(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (qn, kn, vn)),
        causal=causal, window=window)
    np.testing.assert_allclose(_f32(out), _f32(oracle), atol=tol_o,
                               rtol=tol_o)


@pytest.mark.parametrize("case", CASES)
def test_ops_on_cpu_is_the_plain_version(case):
    causal, window = case[6], case[7]
    q, k, v = (_to_torch(x, "float32") for x in _inputs(case, seed=1))
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)[0]
    assert torch.equal(out, ref)


def test_ops_rejects_rows_without_keys():
    q, k, v = (_to_torch(x, "float32")
               for x in _inputs((1, 96, 32, 2, 2, 16)))
    with pytest.raises(ValueError, match="no admissible key"):
        flash_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, causal=True, window=0)

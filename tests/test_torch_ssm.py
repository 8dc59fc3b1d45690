"""The port's Mamba2 mixer (``repro_torch.models.ssm``) against the JAX
package's on the same weights (the reference's ``ssm_init`` draw, handed
over as numpy arrays) and the same numpy inputs, in f32 at the reduced
mamba2 widths (d_model 256, 16 heads of 32, d_state 32, chunk 32) and at
jamba's group count (g 8):

* ``ssm_apply`` with and without ``seq_len``, its decode state (h and the
  conv window) included, through the plain scan against the reference's
  ``"jnp"`` backend and through the port's ``Function`` (``"cuda"`` on CPU
  tensors, i.e. its plain versions) against the reference's ``"pallas"``
  backend in interpret mode;
* chained ``ssm_decode_step`` calls from the prefilled state;
* the causal conv and its one-token form.

Tolerance 1e-4 (atol = rtol): f32 sums in another order over S <= 70.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

TOL = 1e-4
ARCH = "mamba2-2.7b"
D_MODEL = get_reduced(ARCH).d_model
SSM_CFGS = {"g1": get_reduced(ARCH).ssm,
            "g8": dataclasses.replace(get_reduced(ARCH).ssm, n_groups=8,
                                      d_state=16)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=list(SSM_CFGS))
def block(request):
    cfg = SSM_CFGS[request.param]
    jparams = JS.ssm_init(jax.random.PRNGKey(7), D_MODEL, cfg, jnp.float32)
    # the reference's norm_scale and D are ones: draw them so they count
    rng = np.random.default_rng(0)
    jparams = dict(jparams)
    for name in ("norm_scale", "D", "dt_bias", "conv_b"):
        shape = jparams[name].shape
        jparams[name] = jnp.asarray(
            1 + 0.1 * rng.standard_normal(shape, dtype=np.float32))
    return cfg, jparams, _to_torch(jparams)


def _x(B=3, S=70, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, D_MODEL), dtype=np.float32)


def test_ssm_init_matches_reference_shapes(block):
    cfg, jparams, _ = block
    mine = TS.ssm_init(torch.Generator().manual_seed(0), D_MODEL, cfg,
                       torch.float32, "cpu")
    ref = JS.ssm_init(jax.random.PRNGKey(0), D_MODEL, cfg, jnp.float32)
    assert set(mine) == set(ref)
    for name in ref:
        want = ref[name]["w"] if isinstance(ref[name], dict) else ref[name]
        got = mine[name]["w"] if isinstance(mine[name], dict) else mine[name]
        assert tuple(got.shape) == tuple(want.shape), name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    # the deterministic leaves are equal outright
    for name in ("dt_bias", "A_log", "D", "conv_b", "norm_scale"):
        np.testing.assert_allclose(_np(mine[name]), np.asarray(ref[name]),
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("seq_len", [None, [70, 41, 2]],
                         ids=["full", "seq_len"])
@pytest.mark.parametrize("backends", [("torch", "jnp"), ("cuda", "pallas")],
                         ids=["plain-vs-jnp", "function-vs-pallas"])
def test_ssm_apply_matches_reference(block, backends, seq_len):
    cfg, jparams, params = block
    x = _x()
    jl = None if seq_len is None else jnp.asarray(seq_len, jnp.int32)
    tl = None if seq_len is None else torch.tensor(seq_len)
    jout, jst = JS.ssm_apply(jparams, jnp.asarray(x), cfg, return_state=True,
                             seq_len=jl, backend=backends[1])
    out, st = TS.ssm_apply(params, torch.from_numpy(x), cfg,
                           return_state=True, seq_len=tl, backend=backends[0])
    # outputs past a row's seq_len are garbage in both packages
    for r, n in enumerate(seq_len or [x.shape[1]] * x.shape[0]):
        _close(out[r, :n], jout[r, :n])
    _close(st["h"], jst["h"])
    _close(st["conv"], jst["conv"])
    plain = TS.ssm_apply(params, torch.from_numpy(x), cfg, seq_len=tl,
                         backend=backends[0])
    assert torch.equal(plain, out)


def test_ssm_decode_step_matches_reference(block):
    cfg, jparams, params = block
    x = _x(S=37, seed=2)
    lens = [37, 20, 3]
    jl, tl = jnp.asarray(lens, jnp.int32), torch.tensor(lens)
    _, jst = JS.ssm_apply(jparams, jnp.asarray(x), cfg, return_state=True,
                          seq_len=jl)
    _, st = TS.ssm_apply(params, torch.from_numpy(x), cfg,
                         return_state=True, seq_len=tl)
    rng = np.random.default_rng(3)
    for _ in range(4):
        xt = rng.standard_normal((3, 1, D_MODEL), dtype=np.float32)
        jy, jst = JS.ssm_decode_step(jparams, jst, jnp.asarray(xt), cfg)
        y, st = TS.ssm_decode_step(params, st, torch.from_numpy(xt), cfg)
        _close(y, jy)
        _close(st["h"], jst["h"])
        _close(st["conv"], jst["conv"])


def test_state_init_matches_reference(block):
    cfg = block[0]
    ref = JS.ssm_state_init(5, D_MODEL, cfg, jnp.bfloat16)
    mine = TS.ssm_state_init(5, D_MODEL, cfg, torch.bfloat16, "cpu")
    assert set(mine) == set(ref)
    for name in ref:
        assert tuple(mine[name].shape) == ref[name].shape
        assert not mine[name].any()
    assert mine["h"].dtype == torch.float32
    assert mine["conv"].dtype == torch.bfloat16


def test_causal_conv_and_its_decode_form_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    b = rng.standard_normal(12, dtype=np.float32)
    want = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TS._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, want, 1e-6)
    # the last output again, from the window of the three inputs before it
    out, state = TS._conv_decode(torch.from_numpy(x[:, -4:-1]),
                                 torch.from_numpy(x[:, -1]),
                                 *map(torch.from_numpy, (w, b)))
    _close(out, want[:, -1], 1e-6)
    assert torch.equal(state, torch.from_numpy(x[:, -3:]))

"""The port's vision models (``repro_torch.models.segmentation`` and
``changeformer``) against the JAX package on the reference's own weights:
each ``SEG_MODELS`` name and ChangeFormer is initialised by the JAX
package, flattened in its checkpoint key scheme, loaded into the port with
``vision_params_from_flat`` (and given back bitwise by
``vision_params_to_flat``), and run on the same numpy inputs.

The oracle is ``jax.value_and_grad`` of the reference's model run in f64
(``jax.enable_x64``) on those weights: the exact function, to which the
port's f32 run is held at f32 tolerances, and which the port's own f64 run
must reproduce to rounding.  The reference's f32 gradients are no oracle
at 1e-4: on U-Net's first convolution they stray from its own f64 result
by 3.6e-4 of the largest |g|, where the port's f32 gradients stay within
3e-6 of it.

Tolerances, port f32 against the oracle: logits atol = rtol = 1e-4; the
loss rtol 1e-5; every gradient leaf atol 1e-4 x the largest |g| of the
whole gradient, rtol 1e-3 (the whole gradient's scale, because the bias of
a convolution that feeds a group norm has a nearly cancelled gradient).
Port f64 against the oracle: gradients atol 1e-9 x the largest |g|;
ChangeFormer 1e-5, because both packages compute its attention in f32.
``conv`` is held to ``jax.lax.conv_general_dilated`` with ``SAME``
padding, whose odd pixel goes at the end at stride 2.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.models import changeformer as jcf  # noqa: E402
from repro.models import segmentation as jseg  # noqa: E402
from repro_torch.convert import (vision_params_from_flat,  # noqa: E402
                                 vision_params_to_flat)
from repro_torch.models import changeformer as cf  # noqa: E402
from repro_torch.models import segmentation as seg  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

KEY = jax.random.PRNGKey(0)
F64_TOL = {"seg": 1e-9, "changeformer": 1e-5}


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    if name == "changeformer":
        return jcf.changeformer_init(KEY, in_ch=3)
    return jseg.seg_init(name, KEY, width=8)


def _load(jparams, dtype=None):
    flat = _flatten(jparams)
    params = vision_params_from_flat(flat, device="cpu", dtype=dtype)
    if dtype is None:
        back = vision_params_to_flat(params)
        assert set(back) == set(flat)
        for k in flat:
            assert back[k].dtype == flat[k].dtype
            np.testing.assert_array_equal(back[k], flat[k])
    return params


def _inputs(shape=(2, 64, 64, 3), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    m = (rng.uniform(size=shape[:3]) < 0.3).astype(np.int32)
    return x, m


def _oracle(apply_fn, loss_fn, jparams, inputs, masks):
    """Logits, loss and gradients of the reference in f64."""
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), jparams)
        x64 = [np.asarray(x, np.float64) for x in inputs]

        @jax.jit
        def run(p):
            return (apply_fn(p, *x64),
                    *jax.value_and_grad(lambda p: loss_fn(p, *x64,
                                                          masks))(p))
        logits, loss, grads = run(p64)
        return np.asarray(logits), float(loss), _flatten(grads)


def _port_value_and_grad(loss_fn, params):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), vision_params_to_flat(tree_unflatten(params, grads))


def _check_grads(got: dict, want: dict, atol_scale: float, rtol: float):
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=atol_scale * scale,
                                   rtol=rtol, err_msg=k)


def _check_model(kind, jp, apply_fn, loss_fn, j_apply, j_loss, inputs, m):
    want_logits, want_loss, want_grads = _oracle(j_apply, j_loss, jp,
                                                 inputs, m)
    params = _load(jp)
    assert sum(t.numel() for t in tree_leaves(params)) == sum(
        v.size for v in jax.tree.leaves(jp))
    xs = [torch.from_numpy(x) for x in inputs]
    mt = torch.from_numpy(m)
    got = apply_fn(params, *xs)
    assert got.shape == want_logits.shape == m.shape + (2,)
    np.testing.assert_allclose(got.numpy(), want_logits, atol=1e-4,
                               rtol=1e-4)
    loss, grads = _port_value_and_grad(lambda p: loss_fn(p, *xs, mt),
                                       params)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _check_grads(grads, want_grads, 1e-4, 1e-3)
    p64 = _load(jp, torch.float64)
    _, grads64 = _port_value_and_grad(
        lambda p: loss_fn(p, *(x.double() for x in xs), mt), p64)
    _check_grads(grads64, want_grads, F64_TOL[kind], 0.0)


@pytest.mark.parametrize("name", sorted(jseg.SEG_MODELS))
def test_seg_model_matches_jax(name):
    x, m = _inputs()
    _check_model("seg", _jax_params(name),
                 lambda p, x: seg.seg_apply(name, p, x),
                 lambda p, x, m: seg.seg_loss(name, p, x, m),
                 lambda p, x: jseg.seg_apply(name, p, x),
                 lambda p, x, m: jseg.seg_loss(name, p, x, m), [x], m)


def test_changeformer_matches_jax():
    a, m = _inputs((2, 32, 32, 3), seed=1)
    b, _ = _inputs((2, 32, 32, 3), seed=2)
    assert sum(v.size for v in jax.tree.leaves(
        _jax_params("changeformer"))) == 324258
    _check_model("changeformer", _jax_params("changeformer"),
                 cf.changeformer_apply, cf.changeformer_loss,
                 jcf.changeformer_apply, jcf.changeformer_loss, [a, b], m)


def test_seg_metrics_exact():
    logits = torch.zeros((1, 2, 2, 2))
    logits[..., 1] = torch.tensor([[[5.0, -5.0], [5.0, -5.0]]])
    masks = torch.tensor([[[1, 0], [0, 1]]])
    m = seg.seg_metrics(logits, masks)
    assert float(m["precision"]) == pytest.approx(0.5)
    assert float(m["recall"]) == pytest.approx(0.5)
    assert float(m["iou"]) == pytest.approx(1 / 3)
    assert float(m["accuracy"]) == pytest.approx(0.5)
    rng = np.random.default_rng(3)
    lg = rng.standard_normal((3, 16, 16, 2)).astype(np.float32)
    mk = (rng.uniform(size=(3, 16, 16)) < 0.4).astype(np.int32)
    got = seg.seg_metrics(torch.from_numpy(lg), torch.from_numpy(mk))
    want = jseg.seg_metrics(jnp.asarray(lg), jnp.asarray(mk))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)


@pytest.mark.parametrize("size", [8, 9, 16, 31])
@pytest.mark.parametrize("k,stride,dilation", [
    (3, 2, 1), (3, 1, 1), (1, 1, 1), (3, 1, 6), (3, 1, 12), (1, 2, 1)])
def test_conv_same_padding_matches_xla(size, k, stride, dilation):
    rng = np.random.default_rng(size + k)
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = np.asarray(jseg.conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                jnp.asarray(x), stride=stride,
                                dilation=dilation))
    got = seg.conv({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                   torch.from_numpy(x), stride=stride, dilation=dilation)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size", [7, 8])
def test_pool_upsample_group_norm_match_jax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 12)).astype(np.float32)
    for fn in ("_pool", "_upsample", "group_norm"):
        want = np.asarray(getattr(jseg, fn)(jnp.asarray(x)))
        got = getattr(seg, fn)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                   err_msg=fn)


def test_vision_convert_round_trip_keys():
    flat = _flatten(_jax_params("unetpp"))
    assert "nodes/0_1/c2/b" in flat and "enc/0/c1/w" in flat
    params = vision_params_from_flat(flat, device="cpu")
    assert isinstance(params["enc"], list) and len(params["enc"]) == 4
    assert isinstance(params["nodes"], dict) and "0_1" in params["nodes"]
    assert params["enc"][0]["c1"]["w"].shape == (3, 3, 3, 8)   # HWIO
    cflat = _flatten(_jax_params("changeformer"))
    assert "stages/1/blocks/0/qkv/w" in cflat
    cparams = vision_params_from_flat(cflat, device="cpu")
    assert len(cparams["stages"][1]["blocks"]) == 2
    back = vision_params_to_flat(cparams)
    for k, v in cflat.items():
        np.testing.assert_array_equal(back[k], v)

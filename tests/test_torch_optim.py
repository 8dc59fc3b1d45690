"""The port's optimizers and learning-rate schedules against the JAX
package's, on the same numpy parameters and gradients.

f32 tolerance 1e-6: both run the same f32 arithmetic, differing only where
the two libraries round a pow, sqrt or norm differently.  With bf16
optimizer state the moments are rounded to bf16 (8 bits of mantissa) on
both sides, so they are compared at one bf16 ulp (2**-7 relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402
from repro_torch import optim as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SHAPES = {"a": (4, 5), "b": {"c": (7,), "d": (3, 2)}}
OPTIMIZERS = [("sgd", {"weight_decay": 0.01}), ("sgdm", {}), ("adam", {}),
              ("adamw", {}), ("lamb", {})]


def _build(rng, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _build(rng, v) for k, v in shapes.items()}
    return rng.standard_normal(shapes, dtype=np.float32)


def _run(name, kw, state_dtype=None, steps=3, lr=1e-2):
    params_np = _build(np.random.default_rng(0))
    grads_np = [_build(np.random.default_rng(1 + i)) for i in range(steps)]

    jopt = J.get_optimizer(name, state_dtype=state_dtype, **kw)
    jp = tree_map(jnp.asarray, params_np)
    js = jopt.init(jp)
    topt = T.get_optimizer(name, state_dtype=state_dtype, **kw)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params_np)
    ts = topt.init(tp)
    ptrs = [p.data_ptr() for p in tree_leaves(tp)]
    for i, g in enumerate(grads_np):
        jp, js = jopt.update(tree_map(jnp.asarray, g), js, jp,
                             jnp.asarray(i, jnp.int32), jnp.float32(lr))
        topt.update(tree_map(torch.from_numpy, g), ts, tp, i, lr)
    # updated in place: the same tensors hold the new values
    assert [p.data_ptr() for p in tree_leaves(tp)] == ptrs
    return jp, js, tp, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_matches_reference(name, kw):
    jp, js, tp, ts = _run(name, kw)
    for j, t in zip(tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(_np(t), _np(j), atol=1e-6, rtol=1e-6)
    for key in ("m", "v"):
        if key in ts:
            for j, t in zip(tree_leaves(js[key]), tree_leaves(ts[key])):
                np.testing.assert_allclose(_np(t), _np(j), atol=1e-6,
                                           rtol=1e-6)


@pytest.mark.parametrize("name", ["sgdm", "adamw"])
def test_bf16_state_dtype(name):
    jp, js, tp, ts = _run(name, {}, state_dtype="bfloat16")
    for key in ts:
        for j, t in zip(tree_leaves(js[key]), tree_leaves(ts[key])):
            assert t.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(t), _np(j), rtol=2 ** -7,
                                       atol=1e-6)
    for j, t in zip(tree_leaves(jp), tree_leaves(tp)):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(_np(t), _np(j), atol=1e-5, rtol=1e-5)


SCHEDULES = [
    ("constant", (3e-4,), {}),
    ("step_decay", (1e-3,), {"every": 3}),
    ("cosine", (1e-3, 20), {}),
    ("warmup_cosine", (3e-4, 20), {"warmup_steps": 4}),
    ("warmup_cosine", (3e-4, 10), {"warmup_steps": 1}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES,
                         ids=[f"{s[0]}{i}" for i, s in enumerate(SCHEDULES)])
def test_schedules_match_reference(name, args, kw):
    jfn, tfn = getattr(J, name)(*args, **kw), getattr(T, name)(*args, **kw)
    for step in range(0, 25):
        got = tfn(step)
        assert got.dtype == torch.float32 and got.shape == ()
        want = np.asarray(jfn(jnp.asarray(step, jnp.int32)), np.float32)
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)

"""The port's training path against the JAX package on shared weights:
JAX ``init_params`` -> checkpoint-format flat arrays -> ``params_from_flat``.

The loss and every gradient leaf of reduced stablelm-1.6b (4 query over 2
kv heads, layernorm, untied head), granite-3-2b (rmsnorm, tied head),
mamba2-2.7b (SSD mixers, no FFN), qwen3-moe-30b-a3b (MoE on every layer),
jamba-1.5-large-398b (SSD + attention, MoE on every other layer) and
llama4-maverick-400b-a17b (top-1 MoE with a shared expert) agree with
``jax.value_and_grad`` in f32, the MoE auxiliary loss included:
the plain attention and SSD scan against ``"jnp"``, and the port's
flash-attention and SSD-scan ``Function``s (``"cuda"`` on CPU tensors, i.e.
their plain versions) against ``"pallas"`` in interpret mode.  The sequence
(80) is longer than the reduced window (64), so the window is exercised,
and spans three SSD chunks of 32, the last one short.  An SSM layer's
norm2 reaches no output: its gradient is zero in both packages, and every
other leaf must reach the loss.  Tolerances: loss rtol 1e-5; gradients
atol 1e-5, rtol 1e-4 (f32 sums in another order over a 2-layer stack).

Parameters after an Adam step are not compared with the reference: at the
first step the update is about lr * sign(g), so noise-level gradient
differences flip it.  One step's parameters are checked with SGD.

Microbatches do not split an MoE step exactly: each microbatch has its own
capacity pool and its own load-balance statistics, in both packages.  So
the MoE stacks' microbatched step is held against the reference's
microbatched step, and the others' against their own full batch.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro_torch.checkpoint.io import _flatten as port_flatten  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat, params_to_flat  # noqa: E402
from repro_torch.launch.train import train_main  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import constant, sgd  # noqa: E402
from repro_torch.train import (TrainState, init_train_state,  # noqa: E402
                               make_eval_step, make_train_step)
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

NO_MOE_ARCHS = ["stablelm-1.6b", "granite-3-2b", "mamba2-2.7b"]
MOE_ARCHS = ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
             "llama4-maverick-400b-a17b"]
ARCHS = NO_MOE_ARCHS + MOE_ARCHS
B, S, CHUNK = 2, 80, 32


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    jparams = JM.init_params(jax.random.PRNGKey(5), jcfg)
    return jcfg, tcfg, jparams, params_from_flat(_flatten(jparams), tcfg,
                                                 device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_value_and_grad(params, cfg, toks, labels, **kw):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    loss = TM.train_loss(tree_unflatten(params, leaves), cfg, batch, **kw)
    unused = TM.unused_leaves(params, cfg)
    used = iter(torch.autograd.grad(
        loss, [p for p, u in zip(leaves, unused) if not u]))
    grads = [torch.zeros_like(p) if u else next(used)
             for p, u in zip(leaves, unused)]
    return loss.item(), params_to_flat(tree_unflatten(params, grads),
                                       TM.period_len(cfg))


@pytest.mark.parametrize("backends", [("torch", "jnp"), ("cuda", "pallas")],
                         ids=["plain-vs-jnp", "function-vs-pallas"])
def test_loss_and_grads_match_reference(pair, backends):
    jcfg, tcfg, jparams, params = pair
    tcfg = dataclasses.replace(tcfg, attention_backend=backends[0],
                               mixer_backend=backends[0])
    jcfg = dataclasses.replace(jcfg, attention_backend=backends[1],
                               mixer_backend=backends[1])
    if tcfg.family == "dense":
        assert tcfg.sliding_window < S
    toks, labels = _batch(tcfg)
    loss, grads = _port_value_and_grad(params, tcfg, toks, labels,
                                       remat=True, loss_chunk=CHUNK)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)},
                                remat=True, loss_chunk=CHUNK))(jparams)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    jflat = _flatten(jgrads)
    assert set(grads) == set(jflat)
    for key, g in jflat.items():
        np.testing.assert_allclose(grads[key], np.asarray(g), atol=1e-5,
                                   rtol=1e-4, err_msg=key)


def test_forward_logits_match_reference(pair):
    jcfg, tcfg, jparams, params = pair
    toks, _ = _batch(tcfg, s=24, seed=6)
    with torch.no_grad():
        logits = TM.forward(params, tcfg, {"tokens": torch.from_numpy(toks)})
    jlogits, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)


def test_remat_does_not_change_loss_or_grads(pair):
    _, tcfg, _, params = pair
    toks, labels = _batch(tcfg, seed=1)
    a = _port_value_and_grad(params, tcfg, toks, labels, remat=True)
    b = _port_value_and_grad(params, tcfg, toks, labels, remat=False)
    assert a[0] == b[0]
    for key in a[1]:
        np.testing.assert_array_equal(a[1][key], b[1][key], err_msg=key)


def _fresh_state(params, opt):
    p = tree_unflatten(params, [t.clone() for t in tree_leaves(params)])
    return TrainState(p, opt.init(p), 0)


def _torch_batch(toks, labels):
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


def test_one_sgd_step_matches_reference(pair):
    jcfg, tcfg, jparams, params = pair
    toks, labels = _batch(tcfg, seed=2)
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg, jax_sgd())
    jstate = jstate._replace(params=jparams)
    jstep = jax_make_step(jcfg, jax_sgd(), lr_schedule=lambda s: 0.5,
                          donate=False)
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})
    opt = sgd()
    step = make_train_step(tcfg, opt, lr_schedule=constant(0.5))
    state, m = step(_fresh_state(params, opt), _torch_batch(toks, labels))
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    jflat = _flatten(jstate.params)
    flat = params_to_flat(state.params, TM.period_len(tcfg))
    for key, want in jflat.items():
        np.testing.assert_allclose(flat[key], np.asarray(want), atol=1e-5,
                                   rtol=1e-4, err_msg=key)


def test_step_updates_params_in_place(pair):
    _, tcfg, _, params = pair
    opt = sgd()
    state = _fresh_state(params, opt)
    ptrs = [t.data_ptr() for t in tree_leaves(state.params)]
    before = [t.clone() for t in tree_leaves(state.params)]
    step = make_train_step(tcfg, opt, lr_schedule=constant(0.1))
    new, _ = step(state, _torch_batch(*_batch(tcfg, s=16)))
    assert [t.data_ptr() for t in tree_leaves(new.params)] == ptrs
    assert new.params is state.params and new.step == 1
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(new.params)))
    assert not any(t.requires_grad for t in tree_leaves(new.params))


@pytest.mark.parametrize("arch", NO_MOE_ARCHS)
def test_microbatches_match_full_batch(arch):
    _, tcfg, _, params = _pair(arch)
    toks, labels = _batch(tcfg, b=4, s=24, seed=3)
    out = []
    for mb in (1, 2):
        opt = sgd()
        step = make_train_step(tcfg, opt, lr_schedule=constant(0.5),
                               microbatches=mb)
        state, m = step(_fresh_state(params, opt), _torch_batch(toks, labels))
        out.append((m, params_to_flat(state.params, TM.period_len(tcfg))))
    (m1, p1), (m2, p2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    for key in p1:
        np.testing.assert_allclose(p2[key], p1[key], atol=1e-6, rtol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_microbatched_moe_step_matches_reference(arch):
    """Two microbatches of an MoE stack, each with its own capacity pool
    and aux loss: the loss, grad norm and SGD step equal the reference's
    microbatched step, and differ from the full batch's."""
    jcfg, tcfg, jparams, params = _pair(arch)
    toks, labels = _batch(tcfg, b=4, s=24, seed=3)
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg, jax_sgd())
    jstate = jstate._replace(params=jparams)
    jstep = jax_make_step(jcfg, jax_sgd(), lr_schedule=lambda s: 0.5,
                          microbatches=2, donate=False)
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})
    out = {}
    for mb in (1, 2):
        opt = sgd()
        step = make_train_step(tcfg, opt, lr_schedule=constant(0.5),
                               microbatches=mb)
        state, m = step(_fresh_state(params, opt), _torch_batch(toks, labels))
        out[mb] = (m, state)
    m, state = out[2]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert float(out[1][0]["loss"]) != pytest.approx(float(m["loss"]),
                                                     rel=1e-6)
    jflat = _flatten(jstate.params)
    flat = params_to_flat(state.params, TM.period_len(tcfg))
    for key, want in jflat.items():
        np.testing.assert_allclose(flat[key], np.asarray(want), atol=1e-5,
                                   rtol=1e-4, err_msg=key)


def test_grad_clip_scales_the_update_and_reports_the_norm(pair):
    _, tcfg, _, params = pair
    batch = _torch_batch(*_batch(tcfg, s=24, seed=4))
    _, grads = _port_value_and_grad(params, tcfg, batch["tokens"].numpy(),
                                    batch["labels"].numpy())
    gnorm = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                        for g in grads.values()))
    clip = gnorm / 4
    opt = sgd()
    step = make_train_step(tcfg, opt, lr_schedule=constant(1.0),
                           grad_clip=clip)
    state, m = step(_fresh_state(params, opt), batch)
    np.testing.assert_allclose(float(m["grad_norm"]), gnorm, rtol=1e-5)
    moved = params_to_flat(params, TM.period_len(tcfg))
    after = params_to_flat(state.params, TM.period_len(tcfg))
    for key, g in grads.items():
        np.testing.assert_allclose(moved[key] - after[key], g / 4,
                                   atol=1e-6, rtol=1e-4, err_msg=key)


def test_eval_step_is_the_loss_without_grad(pair):
    _, tcfg, _, params = pair
    toks, labels = _batch(tcfg, s=24, seed=5)
    loss = make_eval_step(tcfg)(params, _torch_batch(toks, labels))
    assert not loss.requires_grad
    want, _ = _port_value_and_grad(params, tcfg, toks, labels, remat=False)
    assert loss.item() == pytest.approx(want, rel=1e-6)


def test_train_state_flattens_like_the_reference():
    """The full TrainState (params, AdamW moments, step) flattens to the
    reference's 46 checkpoint keys with the same shapes and dtypes."""
    jcfg, tcfg = jax_reduced("stablelm-1.6b"), get_reduced("stablelm-1.6b")
    jflat = _flatten(jax_init_state(jax.random.PRNGKey(0), jcfg))
    flat = port_flatten(init_train_state(None, tcfg, device="cpu"))
    assert len(jflat) == 46 and set(flat) == set(jflat)
    for key, arr in jflat.items():
        assert flat[key].shape == arr.shape, key
        assert flat[key].dtype == np.asarray(arr).dtype, key


def test_bf16_policy_trains():
    res = train_main("stablelm-1.6b", steps=10, batch=2, seq=16,
                     precision="bf16", log_every=0, device="cpu")
    losses = res["losses"]
    assert len(losses) == 10 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_unported_options_raise(tmp_path, monkeypatch):
    """Both options that were once unported now run: a world-2
    data-parallel gang on the CPU (its losses against world 1's are held
    in ``test_torch_distributed.py``), and the S3 export copies the
    checkpoint directory into the store."""
    from repro_torch.api import RunSpec, run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # each rank's threads
    gang = run(RunSpec(kind="train", overrides={
        "steps": 1, "batch": 2, "seq": 8, "log_every": 0, "world_size": 2,
        "device": "cpu"}))
    assert gang.ok, gang.error
    dist = gang.metrics["dist"]
    assert (dist["world_size"], dist["backend"], dist["local_batch"]) == (
        2, "gloo", 1)
    assert np.isfinite(gang.metrics["losses"]).all()
    res = train_main("stablelm-1.6b", steps=1, batch=2, seq=16, log_every=0,
                     checkpoint_dir=str(tmp_path / "ck"),
                     checkpoint_async=False, s3_root=str(tmp_path / "s3"),
                     device="cpu")
    files = sorted(p for p in (tmp_path / "ck").rglob("*") if p.is_file())
    assert res["s3_objects"] == len(files) > 0

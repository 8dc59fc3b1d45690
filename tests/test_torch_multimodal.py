"""The audio (hubert-xlarge: encoder-only, non-causal, frame embeddings
in, masked prediction out) and vlm (llava-next-mistral-7b: patch
embeddings ahead of the tokens) families against the JAX package on
shared weights: JAX ``init_params`` -> checkpoint-format flat arrays ->
``params_from_flat``, and the same batches (``make_batch`` of either
package gives the same bits).  Reduced configs in f32 at seq 32.

``embed_inputs``, the logits, the loss and every gradient leaf agree at
rtol 1e-5, atol 1e-6, with and without remat; the loss is chunked (12)
with a remainder.  hubert's untied embedding table is read by nothing:
its gradient is exactly zero in both packages, and one AdamW step moves
it by ``-lr*wd*p``, as the reference's does (to the one rounding that
XLA's fused multiply-add saves).  A vlm prefill with per-row
lengths (patches included) gives the reference's logits and KV caches,
and a decode step after it the reference's logits.  The training CLI
runs both families, resumes hubert bitwise, and neither family can be
served: the engine raises before it allocates anything, as do hubert's
decode entry points."""
import functools
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data import inputs as JI  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro_torch.checkpoint import list_checkpoints  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat, params_to_flat  # noqa: E402
from repro_torch.data import inputs as TI  # noqa: E402
from repro_torch.launch.__main__ import main as launch_main  # noqa: E402
from repro_torch.launch.serve import serve_main  # noqa: E402
from repro_torch.launch.train import train_main  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw, constant  # noqa: E402
from repro_torch.serve import ServeEngine, ServeScheduler  # noqa: E402
from repro_torch.train import Preemption, TrainState, make_train_step  # noqa: E402,E501
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

ARCHS = ["hubert-xlarge", "llava-next-mistral-7b"]
B, S, CHUNK = 2, 32, 12
RTOL, ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    jparams = JM.init_params(jax.random.PRNGKey(7), jcfg)
    flat = _flatten(jparams)
    return jcfg, tcfg, jparams, flat, params_from_flat(flat, tcfg,
                                                       device="cpu")


@pytest.fixture(params=ARCHS)
def pair(request):
    return _pair(request.param)


def _batches(jcfg, tcfg, seed=0, b=B, s=S):
    return (JI.make_batch(jcfg, b, s, seed),
            TI.make_batch(tcfg, b, s, seed, device="cpu"))


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def test_the_families_round_trip_bitwise(pair):
    _, tcfg, _, flat, params = pair
    back = params_to_flat(params, TM.period_len(tcfg))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert np.array_equal(back[key], arr), key


def test_embed_inputs_match_the_reference(pair):
    jcfg, tcfg, jparams, _, params = pair
    jb, tb = _batches(jcfg, tcfg)
    jx, jpos, jmask = JM.embed_inputs(jparams, jcfg, jb)
    x, pos, mask = TM.embed_inputs(params, tcfg, tb)
    _close(x, jx)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    if tcfg.family == "vlm":            # no loss over the patch positions
        P = tb["patches"].shape[1]
        assert not mask[:, :P].any() and mask[:, P:].all()


@pytest.mark.parametrize("remat", [True, False])
def test_forward_logits_match_the_reference(pair, remat):
    jcfg, tcfg, jparams, _, params = pair
    jb, tb = _batches(jcfg, tcfg, seed=1)
    jlogits, _ = JM.forward(jparams, jcfg, jb, remat=remat)
    with torch.no_grad():
        logits = TM.forward(params, tcfg, tb, remat=remat)
    assert logits.shape == (B, S, tcfg.vocab)
    _close(logits, jlogits)


def _port_value_and_grad(params, cfg, batch, **kw):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = TM.train_loss(tree_unflatten(params, leaves), cfg, batch, **kw)
    unused = TM.unused_leaves(params, cfg)
    used = iter(torch.autograd.grad(
        loss, [p for p, u in zip(leaves, unused) if not u]))
    grads = [torch.zeros_like(p) if u else next(used)
             for p, u in zip(leaves, unused)]
    return loss.item(), params_to_flat(tree_unflatten(params, grads),
                                       TM.period_len(cfg))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_the_reference(pair, remat):
    jcfg, tcfg, jparams, _, params = pair
    jb, tb = _batches(jcfg, tcfg, seed=2)
    loss, grads = _port_value_and_grad(params, tcfg, tb, remat=remat,
                                       loss_chunk=CHUNK)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, jb, remat=remat,
                                loss_chunk=CHUNK))(jparams)
    np.testing.assert_allclose(loss, float(jloss), rtol=RTOL)
    jflat = _flatten(jgrads)
    assert set(grads) == set(jflat)
    for key, g in jflat.items():
        _close(grads[key], g, key)
    unread = [k for k, g in grads.items() if not np.any(g)]
    if tcfg.family == "audio":
        # the frames bypass the table and the head is untied
        assert unread == ["embed/w"]
        assert not np.any(np.asarray(jflat["embed/w"]))
    else:
        assert unread == []


def test_audio_loss_with_no_supervised_frame_stays_finite():
    jcfg, tcfg, jparams, _, params = _pair("hubert-xlarge")
    jb, tb = _batches(jcfg, tcfg, seed=3)
    jb["mask"] = jnp.zeros_like(jb["mask"])
    tb["mask"] = torch.zeros_like(tb["mask"])
    jloss = JM.train_loss(jparams, jcfg, jb, remat=False)
    loss, grads = _port_value_and_grad(params, tcfg, tb, remat=False)
    assert np.isfinite(loss) and loss == float(jloss) == 0.0
    assert all(np.all(np.isfinite(g)) and not np.any(g)
               for g in grads.values())


def test_adamw_moves_the_unread_embedding_by_its_decay():
    """hubert's embed.w gets a zero gradient, so AdamW's decoupled decay
    alone moves it: p - lr*(wd*p).  The port rounds the product and the
    difference apart (bitwise the f32 formula); the reference's XLA step
    fuses them into one multiply-add, rounded once (bitwise that formula
    in f64, rounded to f32).  So the two agree to one f32 rounding."""
    jcfg, tcfg, jparams, _, params = _pair("hubert-xlarge")
    jb, tb = _batches(jcfg, tcfg, seed=4)
    lr, wd = 0.1, 0.01
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg, jax_adamw())
    jstate, _ = jax_make_step(jcfg, jax_adamw(), lr_schedule=lambda s: lr,
                              donate=False)(
        jstate._replace(params=jparams), jb)
    opt = adamw()
    p = tree_unflatten(params, [t.clone() for t in tree_leaves(params)])
    state, _ = make_train_step(tcfg, opt, lr_schedule=constant(lr))(
        TrainState(p, opt.init(p), 0), tb)
    before = params["embed"]["w"]
    after = state.params["embed"]["w"]
    assert torch.equal(after, before - lr * (wd * before))
    assert torch.equal(state.opt_state["m"]["embed"]["w"],
                       torch.zeros_like(before))
    f32 = np.float32
    p0 = before.numpy()
    decay = (f32(wd) * p0).astype(np.float64)
    fused = (p0.astype(np.float64) - np.float64(f32(lr)) * decay).astype(f32)
    want = np.asarray(jstate.params["embed"]["w"])
    np.testing.assert_array_equal(want, fused)
    np.testing.assert_array_max_ulp(after.numpy(), want, maxulp=1)


def test_vlm_prefill_with_lengths_and_decode_match_the_reference():
    jcfg, tcfg, jparams, _, params = _pair("llava-next-mistral-7b")
    jb, tb = _batches(jcfg, tcfg, seed=5)
    P = tb["patches"].shape[1]
    lengths = [S, P + 5]                  # lengths count the patches too
    jlog, jstate = JM.prefill(jparams, jcfg, jb, 48,
                              lengths=jnp.asarray(lengths, jnp.int32))
    log, state = TM.prefill(params, tcfg, tb, 48,
                            lengths=torch.tensor(lengths))
    _close(log, jlog, "logits")
    assert set(state) == set(jstate["slot0"]) == {"k", "v"}
    for name in state:
        _close(state[name], jstate["slot0"][name], name)
    # a token decoded after the patches and the prompt
    tok = np.array(jnp.argmax(jlog, -1), np.int32)[:, None]
    pos = np.asarray(lengths, np.int32)
    jlog2, _ = JM.decode_step(jparams, jcfg, jstate, jnp.asarray(tok),
                              jnp.asarray(pos))
    log2, _ = TM.decode_step(params, tcfg, state, torch.from_numpy(tok),
                             torch.from_numpy(pos))
    _close(log2, jlog2, "decode logits")


def test_hubert_train_main_preempted_resumes_bitwise(tmp_path):
    kw = dict(steps=4, batch=2, seq=16, log_every=0, device="cpu")
    base = train_main("hubert-xlarge", checkpoint_dir=str(tmp_path / "o"),
                      checkpoint_async=False, **kw)
    assert np.all(np.isfinite(base["losses"]))
    ck = str(tmp_path / "ck")
    with pytest.raises(Preemption):
        train_main("hubert-xlarge", checkpoint_dir=ck, checkpoint_every=2,
                   preempt_at_step=3, **kw)
    res = train_main("hubert-xlarge", checkpoint_dir=ck, checkpoint_every=2,
                     resume=True, **kw)
    assert res["resumed_from_step"] == 2
    assert res["losses"] == base["losses"][2:]
    got, step = load_checkpoint(list_checkpoints(ck)[-1][1])
    want, wstep = load_checkpoint(list_checkpoints(tmp_path / "o")[-1][1])
    assert step == wstep == 4 and set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_run_train_takes_the_vlm_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = launch_main(["run", "train", "--arch", "llava-next-mistral-7b",
                          "--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "16", "--log_every", "0"])
    out = buf.getvalue()
    report = json.loads(out[out.index("{\n"):])
    assert rc == 0 and report["status"] == "succeeded"
    met = report["metrics"]
    assert met["device"] == "cpu" and met["arch"].startswith("llava")
    assert len(met["losses"]) == 2 and np.all(np.isfinite(met["losses"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_neither_family_can_be_served(arch):
    cfg = get_reduced(arch)
    params = TM.init_params(cfg, device="cpu")
    for engine in (ServeEngine, ServeScheduler):
        with pytest.raises(ValueError, match=cfg.name):
            engine(cfg, params, device="cpu")
    # serve_main checks before it makes any weights (no device needed)
    with pytest.raises(ValueError, match=cfg.name):
        serve_main(arch, device="no-such-device")
    if cfg.is_encoder_only:
        with pytest.raises(ValueError, match="encoder-only"):
            TM.init_decode_state(cfg, 2, 16, device="cpu")
        with pytest.raises(ValueError, match="encoder-only"):
            TM.decode_step(params, cfg, {}, torch.zeros((2, 1), dtype=int),
                           torch.zeros(2, dtype=int))


def test_the_encoder_attends_both_ways():
    """hubert is non-causal: a change to the last frame moves the first
    frame's logits (a causal stack would leave them)."""
    _, tcfg, _, _, params = _pair("hubert-xlarge")
    batch = TI.make_batch(tcfg, 1, 16, 9, device="cpu")
    moved = dict(batch, features=batch["features"].clone())
    moved["features"][:, -1] *= -1.0   # (a constant shift: layernorm's)
    with torch.no_grad():
        a = TM.forward(params, tcfg, batch, remat=False)
        b = TM.forward(params, tcfg, moved, remat=False)
    assert not tcfg.causal
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-3

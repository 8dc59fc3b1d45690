"""The port's model against the JAX package on shared weights:
JAX ``init_params`` -> checkpoint-format flat arrays -> ``params_from_flat``,
for the dense decoders, the Mamba2 SSM stack, the MoE stacks (qwen3-moe:
MoE on every layer; llama4: top-1 with a shared expert on every other
layer) and the hybrid jamba stack (SSD and attention layers, MoE on every
other layer, periods of two slots).  Prefill and chained decode logits,
and every tensor of the decode state (KV caches, SSM and conv states),
agree at atol 1e-4 in f32.  The reference stacks each slot's state over
periods (``state["slot{j}"]``); the port stacks the attention layers' and
the SSD layers' states in layer order, and :func:`_port_layout` maps the
one onto the other."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import MoEConfig, SSMConfig, get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat, params_to_flat  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ATOL = 1e-4
ARCHS = ["granite-3-2b", "stablelm-1.6b", "mamba2-2.7b", "glm4-9b",
         "codeqwen1.5-7b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
         "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    jparams = JM.init_params(jax.random.PRNGKey(3), jcfg)
    flat = _flatten(jparams)
    return jcfg, tcfg, jparams, flat, params_from_flat(flat, tcfg,
                                                       device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_layout(jstate, cfg):
    """The reference's decode state (per slot, stacked over periods) in the
    port's layout: each kind's tensors stacked over its layers in layer
    order."""
    plan = JM._slot_plan(cfg)
    out = {}
    for layer in range(cfg.n_layers):
        p, j = divmod(layer, len(plan))
        for name, t in jstate[f"slot{j}"].items():
            out.setdefault(name, []).append(np.asarray(t[p]))
    return {name: np.stack(ts) for name, ts in out.items()}


def _assert_states(tstate, jstate, cfg):
    want = _port_layout(jstate, cfg)
    assert set(tstate) == set(want)
    for name in tstate:
        assert tstate[name].shape == want[name].shape, name
        np.testing.assert_allclose(_np(tstate[name]), want[name], atol=ATOL,
                                   rtol=0, err_msg=name)


def _tokens(cfg, B=3, S=20, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def test_configs_match_reference():
    """The copied configs agree with the reference's, field for field,
    apart from the backend knobs whose values differ by package."""
    for arch in ARCHS:
        j = dataclasses.asdict(jax_reduced(arch))
        t = dataclasses.asdict(get_reduced(arch))
        for d in (j, t):
            d.pop("attention_backend")
            d.pop("mixer_backend")
        assert j == t


def test_flat_round_trip_is_bitwise(pair):
    _, tcfg, _, flat, params = pair
    P = TM.period_len(tcfg)
    if P > 1:                  # the slots of a period differ in their leaves
        with pytest.raises(ValueError):
            params_to_flat(params)
    back = params_to_flat(params, P)
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and back[key].shape == arr.shape
        assert np.array_equal(back[key], arr), key


@pytest.mark.parametrize("lengths", [None, [20, 13, 1]])
def test_prefill_and_decode_match(pair, lengths):
    jcfg, tcfg, jparams, _, params = pair
    toks = _tokens(tcfg)
    cache_len = 32
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths)
    jlog, jstate = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                              cache_len, lengths=jl)
    tlog, tstate = TM.prefill(params, tcfg,
                              {"tokens": torch.from_numpy(toks)}, cache_len,
                              lengths=tl)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=ATOL, rtol=0)
    _assert_states(tstate, jstate, tcfg)

    pos = np.full(3, 20, np.int32) if lengths is None else \
        np.asarray(lengths, np.int32)
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
    for _ in range(3):
        jlog, jstate = JM.decode_step(jparams, jcfg, jstate,
                                      jnp.asarray(tok[:, None]),
                                      jnp.asarray(pos))
        tlog, tstate = TM.decode_step(params, tcfg, tstate,
                                      torch.from_numpy(tok[:, None]),
                                      torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tlog), _np(jlog), atol=ATOL, rtol=0)
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)
        pos = pos + 1
    _assert_states(tstate, jstate, tcfg)
    # a zeroed decode state has the prefill's layout
    zero = TM.init_decode_state(tcfg, 3, 32, device="cpu")
    assert {k: t.shape for k, t in zero.items()} == \
        {k: t.shape for k, t in tstate.items()}


def test_pallas_prefill_matches_port_kernel_path(pair):
    """The JAX prefill through the Pallas kernels (interpret mode) against
    the port's prefill through ops.flash_attention and ops.ssd_scan (their
    plain versions on the CPU), with a window shorter than the prompt."""
    jcfg, tcfg, jparams, _, params = pair
    jcfg = dataclasses.replace(jcfg, attention_backend="pallas",
                               mixer_backend="pallas", sliding_window=16)
    tcfg = dataclasses.replace(tcfg, attention_backend="cuda",
                               mixer_backend="cuda", sliding_window=16)
    toks = _tokens(tcfg, B=2, S=24, seed=1)
    jlog, _ = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 32)
    tlog, _ = TM.prefill(params, tcfg, {"tokens": torch.from_numpy(toks)}, 32)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=ATOL, rtol=0)


def test_sample_tokens_greedy_and_top1():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 50), dtype=np.float32))
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1   # tie: first wins
    gen = torch.Generator().manual_seed(0)
    greedy = TM.sample_tokens(logits, gen, torch.zeros(4), torch.zeros(
        4, dtype=torch.int32), greedy_only=True)
    assert greedy.tolist() == np.argmax(logits.numpy(), -1).tolist()
    assert int(greedy[1]) == 7
    # top_k=1 sampling is greedy wherever the maximum is unique
    top1 = TM.sample_tokens(logits, gen, torch.ones(4),
                            torch.ones(4, dtype=torch.int32))
    assert top1[[0, 2, 3]].tolist() == greedy[[0, 2, 3]].tolist()
    assert int(top1[1]) in (7, 9)


def test_entry_points_need_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("granite-3-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_decode_state(cfg, 2, 16)


def test_other_families_raise():
    for family in ("vlm", "audio"):
        cfg = dataclasses.replace(get_reduced("granite-3-2b"), family=family)
        with pytest.raises(NotImplementedError):
            TM.init_params(cfg, device="cpu")


# plans no registered config has: MoE on every other layer of a dense
# stack, SSD layers with a dense MLP interleaved with attention, and an SSM
# stack with an FFN after the mixer
OTHER_PLANS = {
    "moe": ("granite-3-2b", dict(family="moe"),
            dict(moe=(4, 2, 128, 2))),
    "hybrid": ("granite-3-2b", dict(family="hybrid", n_layers=4,
                                    attn_every=2),
               dict(ssm=(16, 32, 1, 8))),
    "ssm_with_ffn": ("mamba2-2.7b", dict(d_ff=64), {}),
}


def _other_plan(name, reduced, moe_cls, ssm_cls):
    arch, fields, sub = OTHER_PLANS[name]
    fields = dict(fields)
    if "moe" in sub:
        E, K, f, every = sub["moe"]
        fields["moe"] = moe_cls(n_experts=E, top_k=K, expert_d_ff=f,
                                every=every)
    if "ssm" in sub:
        N, hp, g, Q = sub["ssm"]
        fields["ssm"] = ssm_cls(d_state=N, head_dim=hp, n_groups=g, chunk=Q)
    return dataclasses.replace(reduced(arch), **fields)


@pytest.mark.parametrize("name", list(OTHER_PLANS))
def test_other_plans_construct_and_match(name):
    """Slot plans beyond the registered configs' construct, convert and
    match the reference's prefill, decode and state."""
    jcfg = _other_plan(name, jax_reduced, JMoEConfig, JSSMConfig)
    tcfg = _other_plan(name, get_reduced, MoEConfig, SSMConfig)
    assert JM._slot_plan(jcfg) == TM._slot_plan(tcfg)
    jparams = JM.init_params(jax.random.PRNGKey(7), jcfg)
    params = params_from_flat(_flatten(jparams), tcfg, device="cpu")
    assert (set(params_to_flat(params, TM.period_len(tcfg)))
            == set(_flatten(jparams)))
    toks = _tokens(tcfg, B=2, S=12, seed=3)
    lengths = [12, 7]
    jlog, jstate = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                              16, lengths=jnp.asarray(lengths, jnp.int32))
    tlog, tstate = TM.prefill(params, tcfg, {"tokens": torch.from_numpy(toks)},
                              16, lengths=torch.tensor(lengths))
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=ATOL, rtol=0)
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
    pos = np.asarray(lengths, np.int32)
    jlog, jstate = JM.decode_step(jparams, jcfg, jstate, jnp.asarray(tok),
                                  jnp.asarray(pos))
    tlog, tstate = TM.decode_step(params, tcfg, tstate,
                                  torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=ATOL, rtol=0)
    _assert_states(tstate, jstate, tcfg)

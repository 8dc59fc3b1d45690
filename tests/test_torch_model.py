"""The port's model against the JAX package on shared weights:
JAX ``init_params`` -> checkpoint-format flat arrays -> ``params_from_flat``,
for the dense decoders and the Mamba2 SSM stack.  Prefill and chained
decode logits, and every tensor of the decode state (KV caches, or SSM and
conv states), agree at atol 1e-4 in f32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat, params_to_flat  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ATOL = 1e-4
ARCHS = ["granite-3-2b", "stablelm-1.6b", "mamba2-2.7b", "glm4-9b",
         "codeqwen1.5-7b"]


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
    back = params_to_flat(params)
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
    assert set(tstate) == set(jstate["slot0"])
    for name in tstate:
        np.testing.assert_allclose(_np(tstate[name]),
                                   _np(jstate["slot0"][name]), atol=ATOL,
                                   rtol=0)

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
    for name in tstate:
        np.testing.assert_allclose(_np(tstate[name]),
                                   _np(jstate["slot0"][name]), atol=ATOL,
                                   rtol=0)


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
    for family in ("moe", "hybrid", "vlm", "audio"):
        cfg = dataclasses.replace(get_reduced("granite-3-2b"), family=family)
        with pytest.raises(NotImplementedError):
            TM.init_params(cfg, device="cpu")
    # an SSM stack whose plan is not the one ported (an FFN after the mixer)
    cfg = dataclasses.replace(get_reduced("mamba2-2.7b"), d_ff=64)
    with pytest.raises(NotImplementedError):
        TM.init_params(cfg, device="cpu")

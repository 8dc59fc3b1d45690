"""The port's ``LegacyServeEngine`` (one prefill per request at its own
length, the whole logits sampled on the host, the decode state copied
every step) against the port's ``ServeEngine`` and the reference's
``LegacyServeEngine`` on the same converted weights and requests: greedy
f32 tokens equal, as ``tests/test_serve.py`` holds the reference's two
engines, for the dense decoder and the SSM stack; the same input
validation; the engine's costs (one prefill per admission, the state
replaced every step); no card, no engine."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serve import LegacyServeEngine as JLegacy  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.serve import (LegacyServeEngine, Request,  # noqa: E402
                               ServeEngine)
from torch_one_thread import one_thread  # noqa: E402,F401

# (arch, key, requests, slots, cache_len, prompt lengths, max_tokens):
# test_serve.py's two equivalence cases
CASES = [("granite-3-2b", 0, 7, 3, 64, (4, 12), 8),
         ("mamba2-2.7b", 2, 5, 2, 48, (3, 14), 6)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    arch, key, n, slots, cache_len, (lo, hi), max_tokens = request.param
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    jparams = jax_init_params(jax.random.PRNGKey(key), jcfg)
    params = params_from_flat(_flatten(jparams), cfg, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(lo, hi)))
               for _ in range(n)]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                prompts=prompts, slots=slots, cache_len=cache_len,
                max_tokens=max_tokens)


def _drain(engine, request_cls, prompts, max_tokens):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_tokens=max_tokens))
    return {r.rid: tuple(r.generated) for r in engine.run()}


def test_greedy_tokens_equal_both_engines(case):
    """The port's legacy engine, its ``ServeEngine`` and the reference's
    legacy engine give the same greedy tokens for every request."""
    kw = dict(slots=case["slots"], cache_len=case["cache_len"])
    args = (case["prompts"], case["max_tokens"])
    legacy = _drain(LegacyServeEngine(case["cfg"], case["params"],
                                      device="cpu", **kw), Request, *args)
    engine = _drain(ServeEngine(case["cfg"], case["params"], device="cpu",
                                **kw), Request, *args)
    ref = _drain(JLegacy(case["jcfg"], case["jparams"], **kw), JRequest,
                 *args)
    assert len(legacy) == len(case["prompts"])
    assert legacy == engine == ref


def test_costs_one_prefill_per_request_and_a_state_a_step(case,
                                                          monkeypatch):
    """Each admission prefills one request at its own length, and each
    decode step leaves a new state object (the copy), as the
    reference's."""
    import repro_torch.serve.legacy as legacy
    lengths, real = [], legacy.prefill

    def counting(params, cfg, batch, **kw):
        lengths.append(tuple(batch["tokens"].shape))
        return real(params, cfg, batch, **kw)

    monkeypatch.setattr(legacy, "prefill", counting)
    eng = LegacyServeEngine(case["cfg"], case["params"], device="cpu",
                            slots=case["slots"],
                            cache_len=case["cache_len"])
    for i, p in enumerate(case["prompts"]):
        eng.submit(Request(rid=i, prompt=p, max_tokens=case["max_tokens"]))
    before = eng.state
    eng.step()
    assert eng.state is not before
    assert all(eng.state[k] is not before[k] for k in before)
    eng.run()
    assert lengths == [(1, len(p)) for p in case["prompts"]]


@pytest.mark.parametrize("prompt,match", [(np.zeros(0, np.int64), "empty"),
                                          (np.arange(64), "cache_len")])
def test_validation_matches_the_reference(prompt, match):
    """Empty prompts and prompts that do not fit the cache are refused
    with the reference's messages."""
    cfg, jcfg = get_reduced("granite-3-2b"), jax_reduced("granite-3-2b")
    eng = LegacyServeEngine(cfg, {}, device="cpu", slots=1, cache_len=64)
    ref = JLegacy.__new__(JLegacy)
    ref.cache_len, ref.queue = 64, []
    with pytest.raises(ValueError, match=match) as got:
        eng.submit(Request(rid=3, prompt=prompt))
    with pytest.raises(ValueError, match=match) as want:
        ref.submit(JRequest(rid=3, prompt=prompt))
    assert str(got.value) == str(want.value)
    assert jcfg.name == cfg.name


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_no_engine():
    """Without ``device`` the engine takes ``cuda``, and raises here."""
    with pytest.raises(RuntimeError):
        LegacyServeEngine(get_reduced("granite-3-2b"), {}, slots=1,
                          cache_len=16)

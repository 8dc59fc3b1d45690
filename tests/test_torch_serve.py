"""The port's ServeEngine against the JAX ServeEngine on shared weights and
the same requests (greedy tokens identical, for a dense decoder and for the
Mamba2 SSM stack), plus the engine's retirement, validation and sampling
behaviour on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.launch.serve import serve_main  # noqa: E402
from repro_torch.serve import Request, ServeEngine, validate_request  # noqa: E402

ARCH = "granite-3-2b"
CFG = get_reduced(ARCH)


@pytest.fixture(scope="module")
def shared():
    jcfg = jax_reduced(ARCH)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, params_from_flat(_flatten(jparams), CFG,
                                           device="cpu")


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, size=int(rng.integers(4, 20)))
            for _ in range(n)]


def _engine(params, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("cache_len", 64)
    return ServeEngine(CFG, params, device="cpu", **kw)


def test_greedy_tokens_match_jax_engine(shared):
    """7 requests drained through 3 slots in both packages: identical
    greedy tokens, and the same prefill/decode schedule."""
    jcfg, jparams, params = shared
    prompts = _prompts(7, seed=1)
    jeng = JServeEngine(jcfg, jparams, slots=3, cache_len=64)
    teng = _engine(params)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_tokens=8))
        teng.submit(Request(rid=i, prompt=p, max_tokens=8))
    jdone = {r.rid: r.generated for r in jeng.run()}
    tdone = {r.rid: r.generated for r in teng.run()}
    assert len(tdone) == 7
    assert all(len(g) == 8 for g in tdone.values())
    assert tdone == jdone
    for key in ("decode_steps", "prefill_calls", "admitted",
                "host_transfer_bytes"):
        assert teng.stats[key] == jeng.stats[key], key
    summary = teng.stats()
    assert summary["completed"] == 7
    assert summary["flash_attention_launches"] == 0   # CPU: plain version
    assert "prefill_compiles" not in summary


def test_mamba2_greedy_tokens_match_jax_engine():
    """Reduced mamba2 through both engines: the padded prompts of the
    reference's SSM engine test (3-13 tokens through 2 slots, bucketed
    right-padded prefill with frozen states), identical greedy tokens, and
    the SSD scan's plain version on the CPU (no kernel launch)."""
    jcfg, tcfg = jax_reduced("mamba2-2.7b"), get_reduced("mamba2-2.7b")
    jparams = jax_init_params(jax.random.PRNGKey(2), jcfg)
    params = params_from_flat(_flatten(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tcfg.vocab, size=int(rng.integers(3, 14)))
               for _ in range(5)]
    jeng = JServeEngine(jcfg, jparams, slots=2, cache_len=48)
    teng = ServeEngine(tcfg, params, slots=2, cache_len=48, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_tokens=6))
        teng.submit(Request(rid=i, prompt=p, max_tokens=6))
    jdone = {r.rid: r.generated for r in jeng.run()}
    tdone = {r.rid: r.generated for r in teng.run()}
    assert len(tdone) == 5 and all(len(g) == 6 for g in tdone.values())
    assert tdone == jdone
    for key in ("decode_steps", "prefill_calls", "admitted"):
        assert teng.stats[key] == jeng.stats[key], key
    summary = teng.stats()
    assert summary["ssd_scan_launches"] == 0
    assert summary["flash_attention_launches"] == 0


def test_eos_and_max_tokens_retire(shared):
    params = shared[2]
    prompt = _prompts(1, seed=5)[0]
    probe = Request(rid=0, prompt=prompt, max_tokens=4)
    eng = _engine(params, slots=1)
    eng.submit(probe)
    eng.run()
    assert len(probe.generated) == 4 and probe.done
    eos = probe.generated[2]

    req = Request(rid=1, prompt=prompt, max_tokens=16, eos_id=int(eos))
    eng2 = _engine(params, slots=1)
    eng2.submit(req)
    eng2.run()
    assert req.generated[-1] == eos
    assert req.generated == probe.generated[:len(req.generated)]
    assert len(req.generated) <= 3


def test_cache_len_bounds_generation(shared):
    eng = _engine(shared[2], slots=1, cache_len=16)
    req = Request(rid=0, prompt=np.arange(8) % CFG.vocab, max_tokens=100)
    eng.submit(req)
    eng.run()
    assert len(req.generated) == 16 - 8


def test_validate_request():
    with pytest.raises(ValueError, match="empty prompt"):
        validate_request(Request(rid=0, prompt=np.zeros(0, np.int32)), 16)
    with pytest.raises(ValueError, match="cache_len"):
        validate_request(Request(rid=1, prompt=np.zeros(16, np.int32)), 16)
    validate_request(Request(rid=2, prompt=np.zeros(15, np.int32)), 16)


def test_top_k_1_equals_greedy(shared):
    params = shared[2]
    prompts = _prompts(4, seed=2)
    runs = []
    for kw in ({}, {"temperature": 0.8, "top_k": 1}):
        eng = _engine(params, seed=3)
        reqs = [Request(rid=i, prompt=p, max_tokens=6, **kw)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append([r.generated for r in reqs])
    assert runs[0] == runs[1]


def test_sampling_is_seeded(shared):
    params = shared[2]
    outs = []
    for seed in (4, 4):
        eng = _engine(params, seed=seed, greedy=False)
        req = Request(rid=0, prompt=_prompts(1)[0], max_tokens=6)
        eng.submit(req)
        eng.run()
        outs.append(req.generated)
    assert outs[0] == outs[1]


def test_serve_main_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(ARCH)
    with pytest.raises(NotImplementedError):
        serve_main(ARCH, arrival_rate=1.0, device="cpu")


def test_serve_main_on_cpu():
    out = serve_main(ARCH, requests=3, max_tokens=3, device="cpu")
    assert out["requests"] == 3 and out["tokens"] == 9
    assert out["device"] == "cpu" and out["flash_attention_launches"] == 0


def test_serve_main_serves_mamba2_on_cpu():
    out = serve_main("mamba2-2.7b", requests=3, max_tokens=3, device="cpu")
    assert out["arch"] == "mamba2-2.7b-reduced"
    assert out["requests"] == 3 and out["tokens"] == 9
    assert out["ssd_scan_launches"] == 0 and out["prefill_calls"] >= 1

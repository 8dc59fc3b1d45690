"""The port's continuous-batching ServeScheduler against the JAX
ServeScheduler, on shared weights and the same open-loop traces, both
driven by a VirtualClock: the same greedy tokens, shed requests, eviction
counts, KV accounting and service timestamps, for a dense decoder and the
Mamba2 SSM stack, with and without KV-pool pressure and SLO shedding, and
for the jamba hybrid (KV caches and SSM states in one decode state, MoE
capacity shared by co-batched rows) under pressure.
Then the reference's own scheduler cases (validation, the deadlock guard,
priority, shedding, open-loop release, streaming, callbacks, bucket
edges, timing stats) on the port, and ``serve_main``'s continuous mode on
the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import ServeScheduler as JServeScheduler  # noqa: E402
from repro.serve import VirtualClock as JVirtualClock  # noqa: E402
from repro.serve import make_trace as jmake_trace  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.launch.serve import serve_main  # noqa: E402
from repro_torch.serve import (Request, ServeEngine, ServeScheduler,  # noqa: E402
                               VirtualClock, make_trace, poisson_trace)

CFG = get_reduced("granite-3-2b")


@pytest.fixture(scope="module", params=["granite-3-2b", "mamba2-2.7b"])
def pair(request):
    arch = request.param
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, jparams, tcfg, params_from_flat(
        _flatten(jparams), tcfg, device="cpu")


@pytest.fixture(scope="module")
def params():
    jparams = jax_init_params(jax.random.PRNGKey(0), jax_reduced(
        "granite-3-2b"))
    return params_from_flat(_flatten(jparams), CFG, device="cpu")


# scenario -> (trace kind, n, rate, max_tokens, scheduler knobs)
SCENARIOS = {
    "no_pressure": ("poisson", 8, 40.0, 8, {}),
    "oversubscribed_slo": ("bursty", 10, 100.0, 20,
                           dict(max_kv_blocks=8, kv_block_size=8,
                                slo_deadline_ms=150.0)),
}


def _record(sched):
    reqs = sorted(sched.completed + sched.shed, key=lambda r: r.rid)
    s = sched.stats()
    return {
        "tokens": {r.rid: list(r.generated) for r in sched.completed},
        "shed": sorted(r.rid for r in sched.shed),
        "times": {r.rid: (r.t_submit, r.t_admit, r.t_first, r.t_done)
                  for r in reqs},
        "evictions": {r.rid: r.evictions for r in reqs},
        "kv_stats": dict(sched.kv.stats),
        "summary": {k: s[k] for k in (
            "completed", "decode_steps", "prefill_calls", "admitted",
            "shed", "evictions", "slo_met", "kv", "ttft_p50_s",
            "tpot_p99_s", "queue_wait_p99_s")},
        "tick": sched._tick,
    }


def _run_pair(jcfg, jparams, tcfg, params, scenario):
    kind, n, rate, max_tokens, knobs = SCENARIOS[scenario]
    runs = []
    for sched_cls, clock_cls, trace_fn, p, c, extra in (
            (JServeScheduler, JVirtualClock, jmake_trace, jparams, jcfg, {}),
            (ServeScheduler, VirtualClock, make_trace, params, tcfg,
             {"device": "cpu"})):
        sched = sched_cls(c, p, slots=3, cache_len=64,
                          clock=clock_cls(dt_per_step=0.01), **knobs,
                          **extra)
        sched.submit_trace(trace_fn(kind, c.vocab, n, rate, seed=5,
                                    max_tokens=max_tokens))
        sched.run()
        runs.append(_record(sched))
    return runs


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scheduler_matches_jax_scheduler(pair, scenario):
    arch, jcfg, jparams, tcfg, params = pair
    _, n, _, max_tokens, _ = SCENARIOS[scenario]
    want, got = _run_pair(jcfg, jparams, tcfg, params, scenario)
    assert got == want
    s = got["summary"]
    assert s["completed"] + s["shed"] == n and s["kv"]["used_blocks"] == 0
    if scenario == "no_pressure":
        assert s["shed"] == s["evictions"] == 0
        assert all(len(t) == max_tokens for t in got["tokens"].values())
    else:
        assert s["shed"] > 0 and s["evictions"] > 0
        assert got["kv_stats"]["failed_grows"] > 0


def test_hybrid_scheduler_matches_jax_scheduler_under_eviction():
    """The reduced jamba through both schedulers on an oversubscribed pool
    with an SLO: the mixed decode state (KV caches beside SSM states)
    survives the slot insert, eviction and re-prefill, and tokens,
    evictions, shed ids and ``kv.stats`` equal the reference's."""
    arch = "jamba-1.5-large-398b"
    jcfg, tcfg = jax_reduced(arch), get_reduced(arch)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_flat(_flatten(jparams), tcfg, device="cpu")
    want, got = _run_pair(jcfg, jparams, tcfg, params, "oversubscribed_slo")
    assert got == want
    s = got["summary"]
    assert s["shed"] > 0 and s["evictions"] > 0
    assert s["kv"]["used_blocks"] == 0


def test_engine_tick_and_min_bucket_match_reference(pair):
    """The repaired engine hooks: ``_tick`` advances once per prefill
    group and once per decode tick, ``min_bucket`` sets the shortest pad,
    and the static engine's summary has no scheduler fields, as in the
    JAX engine."""
    arch, jcfg, jparams, tcfg, params = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, size=int(n))
               for n in (3, 20, 9, 40, 2)]
    jeng = JServeEngine(jcfg, jparams, slots=2, cache_len=64, min_bucket=16)
    teng = ServeEngine(tcfg, params, slots=2, cache_len=64, min_bucket=16,
                       device="cpu")
    for eng, req_cls in ((jeng, JRequest), (teng, Request)):
        assert [eng.bucket(p) for p in (1, 16, 17, 63)] == [16, 16, 32, 64]
        for i, p in enumerate(prompts):
            eng.submit(req_cls(rid=i, prompt=p, max_tokens=5))
        eng.run()
    assert teng._tick == jeng._tick > 0
    assert teng.stats["prefill_calls"] == jeng.stats["prefill_calls"]
    assert ({r.rid: r.generated for r in teng.completed}
            == {r.rid: r.generated for r in jeng.completed})
    assert "shed" not in teng.stats() and "kv" not in teng.stats()


# ---- the reference's cases (tests/test_serve_sched.py) on the port ----
def _requests(n, seed=0, max_tokens=8, plo=4, phi=12):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, CFG.vocab,
                                        size=int(rng.integers(plo, phi))),
                    max_tokens=max_tokens)
            for i in range(n)]


def _sched(params, **kw):
    return ServeScheduler(CFG, params, device="cpu", **kw)


@pytest.mark.parametrize("make", [
    lambda p: ServeEngine(CFG, p, slots=1, cache_len=32, device="cpu"),
    lambda p: _sched(p, slots=1, cache_len=32),
])
def test_submit_rejects_invalid_prompts(params, make):
    eng = make(params)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(rid=0, prompt=np.array([], np.int32)))
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(Request(rid=1, prompt=np.arange(32) % CFG.vocab))
    # the boundary case fits: cache_len - 1 prompt tokens + 1 generated
    eng.submit(Request(rid=2, prompt=np.arange(31) % CFG.vocab,
                       max_tokens=4))
    done = eng.run()
    assert len(done) == 1 and len(done[0].generated) >= 1


def test_submit_at_validates_before_queueing(params):
    sched = _sched(params, slots=1, cache_len=32)
    with pytest.raises(ValueError):
        sched.submit_at(Request(rid=0, prompt=np.array([], np.int32)), 0.0)
    assert sched.next_arrival() is None


def test_pool_too_small_for_one_request_raises(params):
    with pytest.raises(ValueError, match="deadlock"):
        _sched(params, slots=2, cache_len=64, max_kv_blocks=2,
               kv_block_size=8)


def test_scheduler_matches_engine_on_fixed_trace(params):
    """Token for token: the scheduler on a fixed arrival trace generates
    exactly what the static engine generates for the same prompts."""
    trace = poisson_trace(CFG.vocab, 9, rate_qps=1e6, seed=13,
                          max_tokens=7)
    sched = _sched(params, slots=3, cache_len=64)
    sched.submit_trace(trace)
    sched.run()
    new = {r.rid: tuple(r.generated) for r in sched.completed}

    static = ServeEngine(CFG, params, slots=3, cache_len=64, device="cpu")
    for _, r in trace:
        static.submit(Request(rid=r.rid, prompt=np.asarray(r.prompt),
                              max_tokens=r.max_tokens))
    old = {r.rid: tuple(r.generated) for r in static.run()}
    assert new == old
    assert sched.stats["shed"] == 0 and sched.stats["evictions"] == 0
    assert sched.stats["prefill_calls"] == static.stats["prefill_calls"]


def test_eviction_resume_is_token_identical(params):
    """Oversubscribed pool: LRU eviction + requeue + re-prefill of
    prompt+generated resumes greedy decode exactly where it left off —
    outputs identical to an unconstrained run."""
    mk = lambda: _requests(6, seed=23, max_tokens=20)  # noqa: E731
    ref = _sched(params, slots=3, cache_len=64)
    for r in mk():
        ref.submit(r)
    want = {r.rid: tuple(r.generated) for r in ref.run()}

    # pool of exactly cache_len tokens shared by 3 slots: ~3x oversubscribed
    tight = _sched(params, slots=3, cache_len=64, max_kv_blocks=8,
                   kv_block_size=8)
    for r in mk():
        tight.submit(r)
    got = {r.rid: tuple(r.generated) for r in tight.run()}
    assert got == want
    assert tight.stats["evictions"] > 0            # pressure was real
    assert tight.kv.stats["failed_grows"] > 0
    assert tight.kv.used_blocks == 0               # everything recycled


def test_priority_orders_admission(params):
    sched = _sched(params, slots=1, cache_len=64)
    for r in _requests(3, seed=2, max_tokens=3):
        r.priority = r.rid                 # rid 2 most urgent
        sched.submit(r)
    sched.run()
    assert [r.rid for r in sched.completed] == [2, 1, 0]
    admits = [r.t_admit for r in sorted(sched.completed,
                                        key=lambda r: -r.priority)]
    assert admits == sorted(admits)


def test_slo_shedding_is_deterministic(params):
    """With a virtual clock (10ms per decode step) a queued request whose
    TTFT deadline lapses behind a long-running one is shed, not served."""
    clock = VirtualClock(dt_per_step=0.01)
    sched = _sched(params, slots=1, cache_len=64, clock=clock,
                   slo_deadline_ms=50.0)
    hog, victim = _requests(2, seed=4, max_tokens=20)
    hog.deadline_ms = None                  # the hog never expires
    events = []
    victim.on_token = lambda r, tok, fin: events.append((tok, fin))
    sched.submit(hog)
    sched.submit(victim)
    sched.run()
    assert victim.status == "shed"
    assert victim in sched.shed and victim.t_done is not None
    assert events == [(-1, True)]           # shed notification fired
    assert sched.stats["shed"] == 1
    assert len(hog.generated) == 20
    s = sched.stats()
    assert s["shed"] == 1 and s["completed"] == 1


def test_open_loop_arrivals_release_by_clock(params):
    clock = VirtualClock(dt_per_step=0.01)
    sched = _sched(params, slots=2, cache_len=64, clock=clock)
    a, b = _requests(2, seed=6, max_tokens=4)
    sched.submit_at(a, 0.0)
    sched.submit_at(b, 5.0)                 # far in the virtual future
    assert sched.next_arrival() == 0.0
    sched.run()                             # sleeps the clock forward to b
    assert len(sched.completed) == 2
    assert b.t_submit == 5.0 and b.t_admit >= 5.0
    assert a.t_done < b.t_admit             # b really arrived later


def test_stream_yields_tokens_and_ttft(params):
    sched = _sched(params, slots=2, cache_len=64)
    background = _requests(1, seed=8, max_tokens=10)[0]
    sched.submit(background)
    star = _requests(2, seed=8, max_tokens=6)[1]
    star.rid = 99
    got = []
    for tok in sched.stream(star):
        got.append(tok)
        assert star.t_first is not None     # TTFT stamped by first yield
    assert got == star.generated and len(got) == 6
    sched.run()                             # drain the co-batched request
    assert background.done


def test_on_token_callback_sees_every_token(params):
    sched = _sched(params, slots=1, cache_len=64)
    req = _requests(1, seed=12, max_tokens=5)[0]
    seen = []
    req.on_token = lambda r, tok, fin: seen.append((tok, fin))
    sched.submit(req)
    sched.run()
    assert [t for t, _ in seen] == req.generated
    assert [f for _, f in seen] == [False] * 4 + [True]


def test_bucket_boundary_prompts(params):
    """Prompt lengths sitting exactly on bucket boundaries (8, 16), a
    single-token prompt and the largest admissible prompt all decode, one
    prefill call per bucket group."""
    sched = _sched(params, slots=2, cache_len=64)
    plens = [1, 8, 16, 63]                  # 63 == cache_len - 1
    for i, plen in enumerate(plens):
        sched.submit(Request(rid=i, prompt=(np.arange(plen) * 3) % CFG.vocab,
                             max_tokens=2))
    done = sched.run()
    assert len(done) == len(plens)
    assert all(len(r.generated) >= 1 for r in done)
    assert {sched.bucket(p) for p in plens} == {8, 16, 64}
    # rids 0 and 1 share bucket 8; rids 2 and 3 pad to 16 and 64
    assert sched.stats["prefill_calls"] == 3


def test_mixed_trace_completes_with_bounded_buckets(params):
    """Many prompt lengths, priorities and mid-decode admissions: every
    request completes, each prefill pads to one of the power-of-two
    buckets, and every block returns to the pool."""
    rng = np.random.default_rng(31)
    sched = _sched(params, slots=3, cache_len=64)
    plens = rng.permutation(np.arange(2, 40))
    for i, plen in enumerate(plens):
        sched.submit(Request(rid=i,
                             prompt=(np.arange(plen) * 5) % CFG.vocab,
                             max_tokens=3, priority=int(i % 3)))
    done = sched.run(max_steps=5000)
    assert len(done) == 38
    assert {sched.bucket(int(p)) for p in plens} <= {8, 16, 32, 64}
    assert sched.stats["prefill_calls"] <= sched.stats["admitted"]
    assert sched.kv.used_blocks == 0


def test_timing_stats_surface_in_summary(params):
    clock = VirtualClock(dt_per_step=0.01)
    sched = _sched(params, slots=2, cache_len=64, clock=clock)
    for r in _requests(4, seed=14, max_tokens=6):
        sched.submit(r)
    sched.run()
    s = sched.stats()
    for key in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
                "queue_wait_p50_s", "queue_wait_p99_s"):
        assert s[key] is not None and s[key] >= 0.0, key
    assert s["ttft_p50_s"] <= s["ttft_p99_s"]
    assert s["kv"]["used_blocks"] == 0
    # mapping access (the counter contract) still works
    assert sched.stats["decode_steps"] == s["decode_steps"]
    for r in sched.completed:
        assert r.tpot_s is not None and r.queue_wait_s is not None


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-2.7b"])
def test_serve_main_reports_continuous_metrics(arch):
    """serve_main's continuous mode on the CPU: the reference's continuous
    metric keys, with prefill calls and kernel launches where the
    reference reports its compile counts."""
    m = serve_main(arch, requests=4, slots=2, cache_len=32, max_tokens=4,
                   arrival_rate=200.0, trace="bursty",
                   slo_deadline_ms=60_000.0, max_kv_blocks=4,
                   kv_block_size=8, device="cpu")
    assert m["mode"] == "continuous" and m["trace"] == "bursty"
    assert m["device"] == "cpu"
    assert m["completed"] + m["shed"] == 4
    for key in ("goodput_req_s", "goodput_tok_s", "slo_met", "ttft_p50_s",
                "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
                "queue_wait_p50_s", "queue_wait_p99_s", "evictions", "kv",
                "prefill_calls", "flash_attention_launches",
                "ssd_scan_launches"):
        assert key in m, key
    assert m["kv"]["total_blocks"] == 4 and m["kv"]["used_blocks"] == 0
    assert m["flash_attention_launches"] == m["ssd_scan_launches"] == 0
    assert "decode_compiles" not in m

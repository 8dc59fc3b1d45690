"""The port's open-loop traces against the reference's: for the same seed,
poisson and bursty traces give the same arrival times, prompts, lengths,
priorities and deadlines bit for bit, and the same errors."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import loadgen as jloadgen  # noqa: E402
from repro_torch.serve import loadgen, Request  # noqa: E402


def _same(got, want):
    assert len(got) == len(want)
    for (tg, rg), (tw, rw) in zip(got, want):
        assert isinstance(rg, Request)
        assert tg == tw                               # bitwise float
        assert rg.prompt.dtype == rw.prompt.dtype
        assert np.array_equal(rg.prompt, rw.prompt)
        assert (rg.rid, rg.max_tokens, rg.priority, rg.deadline_ms) == \
            (rw.rid, rw.max_tokens, rw.priority, rw.deadline_ms)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_traces_equal_reference_bitwise(kind, seed):
    kw = dict(seed=seed, plen_range=(16, 1500), max_tokens=32,
              priorities=(0, 1, 2), deadline_ms=5000.0, rid_base=3,
              start=1.5)
    got = loadgen.make_trace(kind, 49_155, 32, 2.0, **kw)
    want = jloadgen.make_trace(kind, 49_155, 32, 2.0, **kw)
    _same(got, want)
    times = [t for t, _ in got]
    assert times == sorted(times) and times[0] > 1.5


def test_defaults_and_burst_sizes_equal_reference():
    _same(loadgen.poisson_trace(512, 9, 1e6, seed=13, max_tokens=7),
          jloadgen.poisson_trace(512, 9, 1e6, seed=13, max_tokens=7))
    for burst in (1, 3, 8):
        _same(loadgen.bursty_trace(512, 10, 50.0, seed=2, burst_size=burst,
                                   jitter_s=0.01),
              jloadgen.bursty_trace(512, 10, 50.0, seed=2, burst_size=burst,
                                    jitter_s=0.01))


@pytest.mark.parametrize("call", [
    lambda m: m.poisson_trace(512, 4, 0.0),
    lambda m: m.bursty_trace(512, 4, -1.0),
    lambda m: m.bursty_trace(512, 4, 1.0, burst_size=0),
    lambda m: m.make_trace("uniform", 512, 4, 1.0),
])
def test_errors_equal_reference(call):
    errors = []
    for mod in (loadgen, jloadgen):
        with pytest.raises(ValueError) as e:
            call(mod)
        errors.append(str(e.value))
    assert errors[0] == errors[1]

"""The probe (``repro_torch.launch.perfprobe``) on the CPU: reduced configs
at an explicit tiny cut, since the cell's own batch and sequence are the
card's.  Its record has the documented fields, names its cut and its
path, holds the analytic roofline for one chip, and never falls back: a
sharded layout raises, and ``cuda`` without a card fails."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.analytic import analytic_roofline  # noqa: E402
from repro_torch.api import RunSpec, run  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch.perfprobe import probe  # noqa: E402
from repro_torch.launch.steps import effective_config  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

FIELDS = {"arch", "shape", "kind", "layout", "mesh", "world_size",
          "device", "device_name", "seq", "seq_of", "batch", "batch_of",
          "cut", "traced", "one_card", "step_s", "warmup_s", "peak_mem_gb",
          "profile", "launches", "allreduce_bytes", "allreduce", "analytic",
          "profile_terms", "finite"}


CELLS = [("stablelm-1.6b", "train_4k"), ("granite-3-2b", "prefill_32k"),
         ("mamba2-2.7b", "prefill_32k"), ("granite-3-2b", "decode_32k"),
         ("hubert-xlarge", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_probe_on_the_cpu(arch, shape):
    rec = probe(arch, shape, device="cpu", reduced=True, batch=2, seq=32)
    assert FIELDS <= set(rec)
    kind = rec["kind"]
    assert (rec["device"], rec["device_name"], rec["layout"]) == (
        "cpu", "cpu", "dp")
    assert rec["cut"] == f"batch 2 of {rec['batch_of']}, seq 32 of " \
        f"{rec['seq_of']}"
    assert rec["traced"] == "cpu: the kernels' plain versions; world 1, dp"
    # no card: no device profile, no device peak, and no kernel launched
    assert rec["profile"] is None and rec["peak_mem_gb"] is None
    assert all(n == 0 for routes in rec["launches"].values()
               for n in routes.values())
    assert rec["allreduce_bytes"] == 0 and rec["finite"]
    if kind == "train":
        assert math.isfinite(rec["loss"])
    cfg = effective_config(get_reduced(arch), shape)
    assert rec["analytic"] == analytic_roofline(
        cfg, 2, 32, kind, {"data": 1, "model": 1}, "dp")
    terms = rec["profile_terms"]
    assert terms["measured_by"] == "host step time"
    assert terms["measured_s"] == rec["step_s"]
    assert terms["collective_bytes"] == 0
    assert terms["flops"] == rec["analytic"]["flops_per_chip"]


@pytest.mark.parametrize("layout,multi_pod", [("fsdp_tp", False),
                                              ("fsdp_sp", False),
                                              ("dp", True)])
def test_sharded_layouts_raise(layout, multi_pod):
    with pytest.raises(ValueError, match="sharding/.* not ported"):
        probe("stablelm-1.6b", "train_4k", layout, multi_pod=multi_pod,
              device="cpu", reduced=True, batch=2, seq=32)


def test_the_dry_run_picks_the_batch():
    """Without an explicit batch the probe takes the dry run's
    ``max_batch_one_card`` (here of the reduced config, which fits at the
    shape's batch over the data axis: 128 // 16)."""
    rec = probe("granite-3-2b", "decode_32k", device="cpu", reduced=True,
                seq=32)
    assert rec["batch"] == rec["one_card"]["max_batch_one_card"] == 8
    # a decode step's bytes scale with its rows: the peak scaled down from
    # the shape's batch is the one traced at the cut
    one = rec["one_card"]
    assert one["traced_peak_bytes"] == pytest.approx(
        one["estimate_peak_bytes"], rel=1e-3)
    assert one["estimate_peak_bytes"] < one["budget_bytes"]
    assert rec["cut"] == "batch 8 of 128, seq 32 of 32768"


def test_the_runner_fails_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = run(RunSpec(kind="perfprobe", arch="stablelm-1.6b",
                    overrides={"shape": "decode_32k"}))
    assert r.status == "failed" and "no CUDA device" in r.error
    r = run(RunSpec(kind="perfprobe", arch="stablelm-1.6b",
                    overrides={"shape": "decode_32k", "layout": "fsdp_tp",
                               "device": "cpu"}))
    assert r.status == "failed" and r.error.startswith("ValueError")

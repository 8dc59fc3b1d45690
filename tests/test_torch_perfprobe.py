"""The probe (``repro_torch.launch.perfprobe``) on the CPU: reduced configs
at an explicit tiny cut, since the cell's own batch and sequence are the
card's.  Its record has the documented fields, names its cut and its
path, holds the analytic roofline for one chip, and never falls back:
the two-pod mesh is traced on meta (nothing runs), and ``cuda`` without
a card fails.  The sharded layouts run as a world-2 gang of ``run
perfprobe`` processes (gloo, one thread a rank) whose losses are the
world-1 step's."""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.analytic import analytic_roofline  # noqa: E402
from repro_torch.api import RunSpec, run  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch.perfprobe import probe  # noqa: E402
from repro_torch.core.executor import parse_trailing_report  # noqa: E402
from repro_torch.launch.steps import effective_config  # noqa: E402
from test_torch_campaign_chaos import ONE_THREAD  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent

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


def _gang_probe(layout: str, tmp_path, *extra, arch="stablelm-1.6b",
                shape="train_4k") -> dict:
    src = str(ROOT / "src")
    path = os.environ.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "run", "perfprobe",
         "--arch", arch, "--shape", shape, "--layout",
         layout, "--world_size=2", "--device=cpu", "--reduced=true",
         "--batch=4", "--seq=32", *extra], cwd=tmp_path, capture_output=True,
        text=True, timeout=240, env={**os.environ, **ONE_THREAD,
                                     "PYTHONPATH": src + (
                                         os.pathsep + path if path else "")})
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    report = parse_trailing_report(proc.stdout)
    assert report["status"] == "succeeded"
    return report["metrics"]


@pytest.mark.parametrize("layout,multi_pod", [("fsdp_tp", False),
                                              ("fsdp_sp", False),
                                              ("dp", True)])
def test_sharded_layouts_raise(layout, multi_pod, tmp_path):
    """The sharded layouts run on the CPU as a world-2 gang, their losses
    those of world 1 (the ``dp`` step) within the gang's f32 tolerance,
    each rank's collective bytes beside the analytic model's; the two-pod
    mesh traces its last rank on meta and runs nothing: under ``dp`` the
    rank of ``{pod: 2, data: 16}`` sums its gradients over the 32 ranks
    that split the batch."""
    if multi_pod:
        rec = probe("stablelm-1.6b", "train_4k", layout, multi_pod=True,
                    reduced=True, batch=64, seq=32)
        assert rec["measured_on"] == "meta" and rec["mesh"] == "2x16x16"
        rank = rec["rank"]
        assert rank["grid"] == {"pod": 2, "data": 16}
        assert rank["rank"] == 31 and rank["rows"] == 2
        grads = rank["bytes"]["params"] + 4           # and the loss
        assert rec["collective_bytes_per_chip"] == {
            "grad_reducescatter": 2 * grads * 31 / 32}
        assert rank["collective_group_sizes"] == {"grad_reducescatter": [32]}
        assert set(rank["resident_minus_sharded"].values()) == {0}
        return
    met = _gang_probe(layout, tmp_path)
    one = probe("stablelm-1.6b", "train_4k", layout, device="cpu",
                reduced=True, batch=4, seq=32)
    assert one["step_layout"] == "dp" and one["world_size"] == 1
    assert (met["layout"], met["step_layout"], met["world_size"]) == (
        layout, layout, 2)
    assert met["traced"] == f"cpu: the kernels' plain versions; world 2, " \
        f"{layout}"
    np.testing.assert_allclose(met["losses"], one["losses"], rtol=1e-5)
    ranks = met["gang"]["ranks"]
    assert [d["rank"] for d in ranks] == [0, 1]
    want = met["analytic_collective_bytes"]
    for d in ranks:
        got = d["collective_bytes"]
        assert d["backend"] == "gloo"
        # the embedding and the head are gathered once, the layers twice
        assert 0.5 * want["fsdp_allgather"] < got["fsdp_allgather"] \
            < want["fsdp_allgather"]
        # the replicated norms are all-reduced instead
        assert 0.95 * want["grad_reducescatter"] < got[
            "grad_reducescatter"] < want["grad_reducescatter"]
        assert got["replicated_allreduce"] > 0


def test_the_model_axis_probe(tmp_path):
    """``--model 2``: the gang's ranks on ``{data: 1, model: 2}`` under
    ``fsdp_tp``, its losses world 1's, each rank's ``tp_allreduce`` bytes
    its count from the shapes, beside the analytic model's for the same
    grid; a model extent that does not divide the world raises."""
    met = _gang_probe("fsdp_tp", tmp_path, "--model=2")
    one = probe("stablelm-1.6b", "train_4k", "fsdp_tp", device="cpu",
                reduced=True, batch=4, seq=32)
    np.testing.assert_allclose(met["losses"], one["losses"], rtol=1e-5)
    assert met["mesh"] == "data 1 x model 2 (one host)"
    assert met["analytic_collective_bytes"]["tp_allreduce"] > 0
    for d in met["gang"]["ranks"]:
        assert d["grid"] == {"data": 1, "model": 2}
        assert d["collective_bytes"]["tp_allreduce"] == d[
            "tp_allreduce_shape_bytes"] > 0
    bad = run(RunSpec(kind="perfprobe", arch="stablelm-1.6b", overrides={
        "shape": "train_4k", "world_size": 2, "model": 4, "device": "cpu"}))
    assert bad.status == "failed" and "does not divide" in bad.error


def test_the_sequence_parallel_probe(tmp_path):
    """``--layout fsdp_sp --model 2``: each rank trains half of the
    sequence, its losses world 1's, its bytes by sequence-parallel
    mechanism ``sp_bytes`` (``sp_shape_bytes``), beside the analytic
    model's ``fsdp_sp`` ``tp_allreduce`` (one K/V gather an attention
    layer, four passes)."""
    met = _gang_probe("fsdp_sp", tmp_path, "--model=2")
    one = probe("stablelm-1.6b", "train_4k", "fsdp_sp", device="cpu",
                reduced=True, batch=4, seq=32)
    np.testing.assert_allclose(met["losses"], one["losses"], rtol=1e-5)
    assert met["mesh"] == "data 1 x model 2 (one host)"
    for d in met["gang"]["ranks"]:
        want = d["sp_shape_bytes"]
        assert {k: d["collective_bytes"].get(k, 0.0) for k in want} == want
        assert want["kv_allgather"] > 0
        assert d["sp_vs_analytic"] == {
            "analytic_tp_allreduce": met["analytic_collective_bytes"][
                "tp_allreduce"],
            "kv_allgather + ssd_state_allgather": want["kv_allgather"],
            "analytic_moe_alltoall": 0.0, "moe_alltoall": 0.0}


@pytest.mark.parametrize("arch,shape,mechanism", [
    ("stablelm-1.6b", "decode_32k", "softmax_combine"),
    ("mamba2-2.7b", "decode_32k", "conv_allgather"),
    ("qwen3-moe-30b-a3b", "train_4k", "moe_alltoall")])
def test_the_sequence_parallel_probe_decodes_and_routes(arch, shape,
                                                        mechanism,
                                                        tmp_path):
    """``--layout fsdp_sp --model 2`` on a decode cell (one token against
    a cache of 32 slots, 16 a rank) and on an MoE arch's train cell: each
    rank's bytes by mechanism are ``sp_shape_bytes`` (the decode step's
    distributed softmax or post-conv gather, the experts' all-to-all),
    and ``sp_vs_analytic`` sets the measured ``moe_alltoall`` beside the
    analytic model's."""
    met = _gang_probe("fsdp_sp", tmp_path, "--model=2", arch=arch,
                      shape=shape)
    analytic = met["analytic_collective_bytes"]
    for d in met["gang"]["ranks"]:
        want = d["sp_shape_bytes"]
        assert {k: d["collective_bytes"].get(k, 0.0) for k in want} == want
        assert want[mechanism] > 0
        assert d["sp_vs_analytic"]["moe_alltoall"] == want["moe_alltoall"]
        assert (d["sp_vs_analytic"]["analytic_moe_alltoall"]
                == analytic["moe_alltoall"])
    if shape == "train_4k":
        assert np.all(np.isfinite(met["losses"]))


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
    # the two-pod mesh is traced on meta, with no card
    r = run(RunSpec(kind="perfprobe", arch="stablelm-1.6b",
                    overrides={"shape": "decode_32k", "multi_pod": True,
                               "device": "cpu"}))
    assert r.status == "succeeded", r.error
    assert r.metrics["measured_on"] == "meta"
    assert r.metrics["rank"]["grid"] == {"pod": 2, "data": 16, "model": 16}

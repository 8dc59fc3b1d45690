"""The dry run's rank section (:func:`repro_torch.launch.dryrun.rank_section`):
one rank of a mesh traced on ``meta`` through a meta rank context.

* Against the reference's compiled device: reduced stablelm at a global
  8 x 64 under ``fsdp_tp`` and ``fsdp_sp``, its ``build_train`` lowered
  and compiled on host meshes ``{data: 2, model: 2}`` and ``{pod: 2,
  data: 2, model: 2}`` of CPU devices (``jax_pod_step.py memory``, one
  subprocess): its ``memory_analysis().argument_size_in_bytes`` is the
  port rank's parameters, optimizer state and rows of the batch plus the
  reference's 4-byte step counter, to the byte.  In the same trace every
  ``fsdp2`` gather runs over the 4 ranks of the rank's pod and
  ``pod_gradsync`` over 2, equal to the count from the shapes.
* ``run_one`` on reduced configs with both meshes (the production
  meshes' axes, each cut to 2 ranks): every layout's rank section holds
  exactly ``sharded_bytes`` (the parameters, gradients, optimizer state
  and decode state of the reference's rules); ``long_500k``'s one row is
  replicated over ``(pod, data)``.  ``fsdp_tp``'s decode state is the
  rules' block too, an SSM with fewer groups than model ranks included.
* Full-width ``decode_32k`` and ``prefill_32k`` records under
  ``fsdp_tp`` on 16x16 for the archs whose kv heads or SSM groups the
  model axis of 16 does not split (granite's 8 kv heads, glm4's 2,
  mamba2's one group): ``resident_minus_sharded`` all 0.
* A full-width llama4-maverick x train_4k x 16x16 x ``fsdp_tp`` record
  (40 query heads on a model axis of 16: the attention whole on every
  rank) is ``ok`` on meta and allocates no parameter on the CPU.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

from test_torch_dryrun import _LargestCPUTensor  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401
import jax_pod_step as J  # noqa: E402
import torch_pod_worker as W  # noqa: E402
import tp_gang_common as TC  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the production meshes' axes, each cut to 2
SMALL = {False: {"data": 2, "model": 2},
         True: {"pod": 2, "data": 2, "model": 2}}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    work = tmp_path_factory.mktemp("pod_memory")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "jax_pod_step.py"), "memory",
         str(work)],
        env=TC._env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads((work / "ref.memory.json").read_text())


@pytest.mark.parametrize("layout", ["fsdp_tp", "fsdp_sp"])
@pytest.mark.parametrize("mesh", list(SMALL.values()),
                         ids=["16x16", "2x16x16"])
def test_held_bytes_are_the_reference_arguments(reference, mesh, layout):
    cfg = get_reduced("stablelm-1.6b")
    rank = D.rank_section(cfg, "train", J.MEMORY_B, J.MEMORY_S, mesh,
                          layout)
    held = sum(rank["bytes"][k] for k in ("params", "optimizer_state",
                                          "inputs"))
    assert held + 4 == reference[W.mesh_tag(mesh) + "." + layout]
    assert set(rank["resident_minus_sharded"].values()) == {0}
    sizes = rank["collective_group_sizes"]
    if "pod" in mesh:
        assert sizes["pod_gradsync"] == [2]
        assert (rank["collective_bytes"]["pod_gradsync"]
                == rank["shape_counts"]["pod_gradsync"] > 0)
    else:
        assert "pod_gradsync" not in sizes
    if layout == "fsdp_sp":
        # the fsdp2 gathers over the plane (4 ranks), the rest over data
        assert sizes["fsdp_allgather"] == [2, 4]


CELLS = [(arch, shape, layout)
         for layout in ("dp", "fsdp_tp", "fsdp_sp")
         for arch, shape in (("stablelm-1.6b", "train_4k"),
                             ("qwen3-moe-30b-a3b", "train_4k"),
                             ("jamba-1.5-large-398b", "train_4k"),
                             ("mamba2-2.7b", "prefill_32k"),
                             ("granite-3-2b", "long_500k"),
                             ("mamba2-2.7b", "long_500k"))
         # the hybrid's dp step is stablelm's and qwen3's data parallelism
         if (arch, layout) != ("jamba-1.5-large-398b", "dp")]


@pytest.mark.parametrize("arch,shape,layout", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_both_meshes_hold_the_rules_blocks(monkeypatch, arch, shape,
                                           layout):
    monkeypatch.setattr(D, "get_config", get_reduced)
    monkeypatch.setattr(D, "production_dims", lambda mp=False: SMALL[mp])
    one_card = {}
    for multi_pod in (False, True):
        rec = D.run_one(arch, shape, multi_pod, layout, None,
                        one_card=one_card)
        assert rec["status"] == "ok", rec.get("error")
        rank = rec["rank"]
        mesh = SMALL[multi_pod]
        want = (mesh if layout != "dp"
                else {a: n for a, n in mesh.items() if a != "model"})
        assert rank["grid"] == want
        assert rank["rank"] == 2 ** len(want) - 1
        diff = rank["resident_minus_sharded"]
        assert set(diff.values()) == {0}, diff
        if shape == "long_500k":
            assert rank["rows"] == 1           # replicated over (pod, data)
        assert rank["traced_over_analytic"] > 0
        assert rank["fits_one_card"]


FULL_SERVE = [(arch, shape) for arch in ("granite-3-2b", "glm4-9b",
                                         "mamba2-2.7b")
              for shape in ("decode_32k", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", FULL_SERVE,
                         ids=["-".join(c) for c in FULL_SERVE])
def test_full_width_fsdp_tp_serving_holds_the_rules_blocks(arch, shape):
    """Rank 255 of 16x16 under ``fsdp_tp`` at full width on meta: where a
    model rank shares a kv head (granite's 8 on 16 ranks, glm4's 2) or
    an SSM group (mamba2's one), its decode state is still exactly the
    rules' block (it held 2x, 8x and the whole B and C before)."""
    rec = D.run_one(arch, shape, False, "fsdp_tp", None)
    assert rec["status"] == "ok", rec.get("error")
    rank = rec["rank"]
    assert rank["rank"] == 255
    assert set(rank["resident_minus_sharded"].values()) == {0}, rank[
        "resident_minus_sharded"]
    assert rank["bytes"]["decode_state"] == rec["sharded_bytes"][
        "decode_state"] > 0


def test_full_width_llama4_rank_on_meta():
    cfg = get_config("llama4-maverick-400b-a17b")
    assert cfg.n_heads % 16
    watch = _LargestCPUTensor()
    with watch:
        rec = D.run_one("llama4-maverick-400b-a17b", "train_4k", False,
                        "fsdp_tp", None)
    assert rec["status"] == "ok", rec.get("error")
    assert watch.numel < cfg.d_model
    rank = rec["rank"]
    assert rank["grid"] == {"data": 16, "model": 16} and rank["rank"] == 255
    assert set(rank["resident_minus_sharded"].values()) == {0}
    # the whole attention's weights are gathered over model, as counted
    assert (rank["collective_bytes"]["tp_weights"]
            >= rank["shape_counts"]["tp_weights_whole_attention"] > 0)
    assert rank["collective_bytes"]["tp_allreduce"] == (
        rank["shape_counts"]["tp_allreduce"])

"""The experts under ``fsdp_sp`` on the grid ``{data: 1, model: 2}``: a
world-2 gang (gloo on the CPU, one thread a rank) of
``torch_sp_worker.py`` runs ``torch_sp_worker.RUNS["moe"]`` on the
reduced f32 qwen3-moe (an MoE FFN every layer) and jamba (SSD and
attention layers, an MoE FFN every other layer beside dense MLPs): each
rank dispatches its block of 4 x 64 tokens as one group, exchanges its
``(E, C, d)`` buffer with the experts' owners in one all-to-all and
back, trains one step, prefills 4 x 128 and decodes 4 steps (there the
token is replicated: the rank's experts, their partial sums
all-reduced).  Held against:

* the port's world 1 on the same weights and batch under the mesh's
  ``fsdp_sp`` ctx, whose ``seq`` groups are the reference's dispatch
  groups (capacity counted over each block's tokens): the loss (rtol
  1e-5), the gathered gradients and the step's ``grad_norm`` (atol 1e-5,
  rtol 1e-4), every decode step's logits and the state blocks;
* the reference's own ``build_train(cfg, mesh, "fsdp_sp")`` on a ``(data
  1, model 2)`` host mesh (``jax_sp_step.py``): its loss and
  ``grad_norm``; its jitted prefill and ``build_decode`` step: the
  logits and the state blocks;
* the shape count: each rank's bytes by mechanism in the train step, the
  prefill and each decode step equal :func:`repro_torch.sharding.sp.
  sp_bytes`, ``moe_alltoall`` included.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.moe import capacity_of  # noqa: E402
from repro_torch.sharding.sp import sp_bytes  # noqa: E402

from torch_one_thread import one_thread  # noqa: E402,F401
import sp_gang_common as C  # noqa: E402
import torch_sp_worker as W  # noqa: E402
import tp_gang_common as TC  # noqa: E402

RUNS = W.RUNS["moe"]
IDS = [r.arch for r in RUNS]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp_moe")
    C.start(work, "moe", 2, 2)
    return work


@pytest.fixture(scope="module")
def world1(gang):
    return {r.tag: C.world1_run(gang, r) for r in RUNS}


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_loss_grads_and_step_equal_world1(gang, world1, run):
    want = world1[run.tag]
    for rank in range(2):
        got, info = C.load_run(gang, rank, run)
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=TC.LOSS_RTOL)
        for key, w in want["grad"].items():
            TC.close(got[f"grad/{key}"], w, f"{run.arch} grad {key}")
        np.testing.assert_allclose(info["step"]["loss"],
                                   want["step"]["loss"], rtol=TC.LOSS_RTOL)
        TC.close(info["step"]["grad_norm"], want["step"]["grad_norm"],
                 f"{run.arch} grad_norm")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_step_matches_the_reference_fsdp_sp_step(gang, run):
    ref = json.loads((gang / f"ref.{run.tag}.json").read_text())
    for rank in range(2):
        _, info = C.load_run(gang, rank, run)
        np.testing.assert_allclose(info["step"]["loss"], ref["loss"],
                                   rtol=TC.LOSS_RTOL)
        TC.close(info["step"]["grad_norm"], ref["grad_norm"],
                 f"{run.arch} grad_norm")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_prefill_and_decode_equal_world1_and_the_reference(gang, world1,
                                                           run):
    ref = dict(np.load(gang / f"ref.{run.tag}.npz"))
    for want, what in ((world1[run.tag], "world 1"), (
            {"logits": ref["logits"],
             "state": {k[len("state/"):]: v for k, v in ref.items()
                       if k.startswith("state/")}}, "the reference")):
        for rank in range(2):
            got, _ = C.load_run(gang, rank, run)
            TC.close(got["logits"], want["logits"],
                     f"{run.arch} logits vs {what}")
            for k, w in want["state"].items():
                TC.close(got[f"state/{k}"], C.block_of(w, k, rank, 2),
                         f"{run.arch} state {k} vs {what}")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_bytes_are_the_shape_count(gang, run):
    """Each rank's bytes by mechanism equal ``sp_bytes`` in the train
    step, the prefill and each decode step.  The all-to-all moves half
    the ``(E, C, d)`` f32 buffer each way, C counted over the block's
    tokens: six times a layer in training (forward, recompute,
    backward), twice in a prefill, never in decode."""
    cfg = get_reduced(run.arch)
    n_moe = sum(cfg.moe_layer_mask())
    buf = (cfg.moe.n_experts * capacity_of(W.B * run.seq // 2, cfg.moe)
           * cfg.d_model * 4)
    for rank in range(2):
        _, info = C.load_run(gang, rank, run)
        parts = [("train", run.seq, info["bytes"]),
                 ("prefill", run.seq, info["prefill_bytes"])]
        parts += [("decode", run.cache, b) for b in info["decode_bytes"]]
        for kind, seq, got in parts:
            want = sp_bytes(cfg, W.B, seq, kind, 2, 4)
            assert {k: got.get(k, 0.0) for k in want} == want, kind
            assert set(got) <= set(want) | C.FSDP_MECHANISMS, kind
        assert info["bytes"]["moe_alltoall"] == 6 * n_moe * buf / 2
        assert info["prefill_bytes"]["moe_alltoall"] == 2 * n_moe * buf / 2
        assert all("moe_alltoall" not in b for b in info["decode_bytes"])

"""``fsdp_sp`` serves on the grid ``{data: 1, model: 2}``: a world-2 gang
(gloo on the CPU, one thread a rank) of ``torch_sp_worker.py`` runs
``torch_sp_worker.RUNS["decode"]`` on the reduced f32 configs and the
reference's weights: stablelm (a windowed cache of 64 slots, 32 a rank)
and mamba2 (the SSM heads and the conv's ``[x, B, C]`` channels split)
prefill 4 x 128 and decode 4 steps; stablelm decodes after an 8-token
prompt into 64 slots, so rank 1's 32 are all masked in every step; and
mamba2 trains, prefills and decodes at blocks of 16 under its chunk of
32 (the whole-sequence fallback).  Held against:

* the port's world-1 prefill and decode on the same weights, batch and
  tokens under the mesh's ``fsdp_sp`` ctx: every step's logits and each
  rank's blocks of the decode state after the last step (atol 1e-5,
  rtol 1e-4: the softmax's and the norms' f32 sums in another order);
  the short block's loss (rtol 1e-5), gradients and step;
* the reference's prefill jitted on a ``(data 1, model 2)`` host mesh
  and its own ``build_decode(cfg, mesh, "fsdp_sp")`` step
  (``jax_sp_step.py``): the logits and the state blocks at the same
  tolerance; the short block's ``build_train`` loss and ``grad_norm``;
* the rules: each rank's state blocks are ``decode_state_shardings``'s;
* the shape count: each rank's bytes by mechanism in the prefill, in
  each decode step and in the train step equal :func:`repro_torch.
  sharding.sp.sp_bytes`.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distributed import DistContext  # noqa: E402
from repro_torch.models.model import init_decode_state  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.grid import RankGrid  # noqa: E402
from repro_torch.sharding.sp import sp_bytes  # noqa: E402

from torch_one_thread import one_thread  # noqa: E402,F401
import sp_gang_common as C  # noqa: E402
import torch_sp_worker as W  # noqa: E402
import tp_gang_common as TC  # noqa: E402

RUNS = W.RUNS["decode"]
IDS = [r.tag for r in RUNS]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp_decode")
    C.start(work, "decode", 2, 2)
    return work


@pytest.fixture(scope="module")
def world1(gang):
    return {r.tag: C.world1_run(gang, r) for r in RUNS}


def _ref(work, run) -> dict:
    return dict(np.load(work / f"ref.{run.tag}.npz"))


def _states_close(got: dict, whole: dict, rank: int, what: str) -> None:
    assert {k[len("state/"):] for k in got if k.startswith("state/")} \
        == set(whole), what
    for k, w in whole.items():
        TC.close(got[f"state/{k}"], C.block_of(w, k, rank, 2),
                 f"{what} state {k}")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_decode_equals_world1(gang, world1, run):
    want = world1[run.tag]
    for rank in range(2):
        got, _ = C.load_run(gang, rank, run)
        assert got["logits"].shape == want["logits"].shape
        TC.close(got["logits"], want["logits"], f"{run.tag} logits")
        _states_close(got, want["state"], rank, run.tag)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_decode_matches_the_reference_fsdp_sp_step(gang, run):
    """The reference's jitted prefill and ``build_decode`` step on a
    ``(data 1, model 2)`` host mesh: every step's logits and the state
    after the last, block by block."""
    ref = _ref(gang, run)
    whole = {k[len("state/"):]: v for k, v in ref.items()
             if k.startswith("state/")}
    for rank in range(2):
        got, _ = C.load_run(gang, rank, run)
        TC.close(got["logits"], ref["logits"], f"{run.tag} logits")
        _states_close(got, whole, rank, f"{run.tag} vs the reference")


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_each_rank_holds_its_state_blocks(gang, run):
    """The cache slots, SSM heads and conv channels of the rules'
    ``decode_state_shardings`` on ``{data: 1, model: 2}``, and
    ``init_decode_state``'s zeroed blocks of the same shapes."""
    cfg = get_reduced(run.arch)
    whole = init_decode_state(cfg, W.B, run.cache, device="meta")
    specs = rules.decode_state_shardings(whole, run.mesh, "fsdp_sp")
    want = {k: list(rules.shard_shape(t.shape, specs[k], run.mesh))
            for k, t in whole.items()}
    assert any(w != list(whole[k].shape) for k, w in want.items())
    for rank in range(2):
        _, info = C.load_run(gang, rank, run)
        assert info["state_shapes"] == want
    grid = RankGrid(run.mesh, DistContext(
        world_size=2, rank=1, coordinator=None, device=torch.device("cpu"),
        backend=None))
    zero = init_decode_state(cfg, W.B, run.cache, device="cpu", grid=grid,
                             layout="fsdp_sp")
    assert {k: list(t.shape) for k, t in zero.items()} == want
    assert all(not t.any() for t in zero.values())


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_bytes_are_the_shape_count(gang, run):
    """The prefill, each decode step and (where the run trains) the
    train step: each rank's bytes by mechanism equal ``sp_bytes``, f32
    throughout; nothing else moves but the FSDP storage's."""
    cfg = get_reduced(run.arch)
    for rank in range(2):
        _, info = C.load_run(gang, rank, run)
        parts = [("prefill", run.seq, info["prefill_bytes"])]
        parts += [("decode", run.cache, b) for b in info["decode_bytes"]]
        if run.train:
            parts.append(("train", run.seq, info["bytes"]))
        for kind, seq, got in parts:
            want = sp_bytes(cfg, W.B, seq, kind, 2, 4)
            assert {k: got.get(k, 0.0) for k in want} == want, kind
            assert set(got) <= set(want) | C.FSDP_MECHANISMS, kind
        decode = info["decode_bytes"][0]
        assert decode["vocab_allgather"] > 0
        assert decode["softmax_combine" if cfg.has_attention
                      else "conv_allgather"] > 0


def test_an_all_masked_block_weighs_nothing(gang, world1):
    """An 8-token prompt in a cache of 64 slots: rank 1's 32 slots hold
    no position in any of the 4 steps (its block stays zeros, never
    written); its partial softmax weighs zero, so the logits are finite
    and world 1's."""
    run = next(r for r in RUNS if r.seq + r.decode <= r.cache // 2)
    got, _ = C.load_run(gang, 1, run)
    assert not got["state/k"].any() and not got["state/v"].any()
    for rank in range(2):
        got, _ = C.load_run(gang, rank, run)
        assert np.isfinite(got["logits"]).all()
        TC.close(got["logits"], world1[run.tag]["logits"], "all masked")


def test_a_block_under_the_chunk_trains_as_world1_and_the_reference(
        gang, world1):
    """mamba2 at 4 x 32, blocks of 16 under its chunk of 32: the mixer's
    input gathered, the whole sequence's scan, the rank's block of its
    output.  The loss, the gathered gradients and the step's ``grad_norm``
    against world 1 and the reference's ``build_train``."""
    run = next(r for r in RUNS if r.train)
    cfg = get_reduced(run.arch)
    assert run.seq // 2 < cfg.ssm.chunk
    want = world1[run.tag]
    ref = json.loads((gang / f"ref.{run.tag}.json").read_text())
    for rank in range(2):
        got, info = C.load_run(gang, rank, run)
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=TC.LOSS_RTOL)
        for key, w in want["grad"].items():
            TC.close(got[f"grad/{key}"], w, f"grad {key}")
        np.testing.assert_allclose(info["step"]["loss"], ref["loss"],
                                   rtol=TC.LOSS_RTOL)
        TC.close(info["step"]["grad_norm"], want["step"]["grad_norm"],
                 "grad_norm")
        TC.close(info["step"]["grad_norm"], ref["grad_norm"],
                 "grad_norm vs the reference")
        assert info["bytes"]["sp_allgather"] > 0
        assert "conv_halo" not in info["bytes"]

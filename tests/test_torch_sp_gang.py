"""``fsdp_sp`` on the grid ``{data: 1, model: 2}``: a world-2 gang (gloo on
the CPU, one thread a rank) of ``torch_sp_worker.py`` computes, for
reduced f32 stablelm, granite, mamba2 (a block of 64 over its chunk of
32), hubert (non-causal) and llava (patches ahead of the tokens), each
rank on its block of the sequence, the loss and gradients, an AdamW and
a LAMB step, the flat-key round trip and a prefill.  Held against:

* the port's world-1 step on the same weights and global batch: the loss
  (rtol 1e-5), the gradients and the steps' loss and ``grad_norm`` (atol
  1e-5, rtol 1e-4: f32 partial sums added in another order); both steps'
  updates against world 1's update by the gang's own gradients; the
  prefill's last-token logits and its decode state gathered from the
  ranks' blocks, within the same tolerance;
* the rules: each rank holds exactly its spec's block of each leaf
  (``fsdp2`` split over both axes), its gradients come back in the same
  shapes, and its decode state is its ``decode_state_shardings`` block;
* the shape count: each rank's bytes by mechanism in the step and the
  prefill equal :func:`repro_torch.sharding.sp.sp_bytes`;
* the reference's own ``build_train(cfg, mesh, "fsdp_sp")`` on a host
  mesh ``(data 1, model 2)`` of two CPU devices, in a subprocess
  (``jax_sp_step.py``): its loss and ``grad_norm`` before its update;
* and a ragged prefill, which the layout does not take, raises.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.data.inputs import make_batch  # noqa: E402
from repro_torch.distributed import DistContext  # noqa: E402
from repro_torch.models.model import (init_decode_state,  # noqa: E402
                                      init_params, prefill)
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.fsdp import FSDP  # noqa: E402
from repro_torch.sharding.grid import RankGrid  # noqa: E402
from repro_torch.sharding.sp import sp_bytes  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_one_thread import one_thread  # noqa: E402,F401
import sp_gang_common as C  # noqa: E402
import torch_sp_worker as W  # noqa: E402
import tp_gang_common as TC  # noqa: E402

CASES = W.CASES["model2"]
IDS = [a for a, _, _ in CASES]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp_gang")
    C.start(work, "model2", 2, 2)
    return work


@pytest.fixture(scope="module")
def world1(gang):
    return {arch: C.world1(gang, arch, serve) for arch, _, serve in CASES}


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_loss_grads_and_steps_equal_world1(gang, world1, arch, mesh, serve):
    want = world1[arch]
    for rank in range(2):
        got, info = C.load(gang, rank, arch, mesh)
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=TC.LOSS_RTOL)
        for key, w in want["grad"].items():
            TC.close(got[f"grad/{key}"], w, f"{arch} grad {key}")
        grads = {k[len("grad/"):]: v for k, v in got.items()
                 if k.startswith("grad/")}
        for name in (get_reduced(arch).optimizer, "lamb"):
            metrics = want[name]
            np.testing.assert_allclose(info[name]["loss"], metrics["loss"],
                                       rtol=TC.LOSS_RTOL)
            TC.close(info[name]["grad_norm"], metrics["grad_norm"],
                     f"{arch} {name} grad_norm")
            for key, w in C.update(gang, arch, name, grads).items():
                TC.close(got[f"{name}/{key}"], w, f"{arch} {name} {key}")
        assert info["round_trip_bitwise"]


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_prefill_equals_world1(gang, world1, arch, mesh, serve):
    want = world1[arch]
    for rank in range(2):
        got, _ = C.load(gang, rank, arch, mesh)
        TC.close(got["logits"], want["logits"].numpy(), f"{arch} logits")
        state = {k.split("/", 1)[1]: v for k, v in got.items()
                 if k.startswith("prefill_state/")}
        assert set(state) == set(want["prefill_state"])
        for k, w in want["prefill_state"].items():
            TC.close(state[k], w.numpy(), f"{arch} prefill state {k}")


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_each_rank_holds_its_block(gang, arch, mesh, serve):
    """Block shapes by the rules on ``{data: 1, model: 2}`` (the
    attention and SSM projections halved by ``fsdp2``), gradients in the
    same shapes, and the prefill's decode state in the blocks of
    ``decode_state_shardings``."""
    cfg = get_reduced(arch)
    params = params_from_flat(dict(np.load(gang / f"{arch}.params.npz")),
                              cfg, device="cpu")
    specs = tree_leaves(rules.param_shardings(params, mesh, "fsdp_sp"))
    leaves = tree_leaves(params)
    want = [list(rules.shard_shape(t.shape, s, mesh))
            for t, s in zip(leaves, specs)]
    assert sum(("data", "model") in s for s in specs) > 4
    states = ({} if cfg.is_encoder_only else
              init_decode_state(cfg, W.B, W.S, device="meta"))
    state_specs = rules.decode_state_shardings(states, mesh, "fsdp_sp")
    for rank in range(2):
        _, info = C.load(gang, rank, arch, mesh)
        assert info["coords"] == {"data": 0, "model": rank}
        assert info["groups"] == {"data": [rank], "model": [0, 1],
                                  "world": [0, 1]}
        assert info["shard_shapes"] == want
        assert info["grad_shapes"] == want
        assert info["state_shapes"] == {
            k: list(rules.shard_shape(t.shape, state_specs[k], mesh))
            for k, t in states.items()}


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_bytes_are_the_shape_count(gang, arch, mesh, serve):
    """The step (forward, remat, backward) and the prefill: each rank's
    bytes by mechanism equal ``sp_bytes``, f32 throughout; nothing else
    moves but the FSDP storage's gathers and reductions."""
    cfg = get_reduced(arch)
    for rank in range(2):
        _, info = C.load(gang, rank, arch, mesh)
        for kind, got in (("train", info["bytes"]),
                          ("prefill", info["prefill_bytes"])):
            want = sp_bytes(cfg, W.B, W.S, kind, 2, 4)
            assert {k: got.get(k, 0.0) for k in want} == want, kind
            assert set(got) <= set(want) | C.FSDP_MECHANISMS, kind
        if cfg.has_attention:
            assert info["bytes"]["kv_allgather"] > 0
        else:
            assert info["bytes"]["ssd_state_allgather"] > 0


@pytest.mark.parametrize("arch,mesh,serve", W.REF["model2"],
                         ids=[a for a, _, _ in W.REF["model2"]])
def test_matches_the_reference_fsdp_sp_step(gang, arch, mesh, serve):
    """The reference's ``build_train`` on a ``(data 1, model 2)`` host
    mesh: loss and ``grad_norm`` before its update."""
    ref = json.loads((gang / f"ref.{W.tag(arch, mesh)}.json").read_text())
    _, info = C.load(gang, 0, arch, mesh)
    got = info[get_reduced(arch).optimizer]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=TC.LOSS_RTOL)
    TC.close(got["grad_norm"], ref["grad_norm"], f"{arch} grad_norm")


def _grid():
    return RankGrid({"data": 1, "model": 2}, DistContext(
        world_size=2, rank=1, coordinator=None, device=torch.device("cpu"),
        backend=None))


@pytest.mark.parametrize("case", ["ragged"])
def test_what_fsdp_sp_does_not_run_raises(case):
    """A prefill with ragged lengths raises before any collective (the
    reference's sharded ``build_prefill`` passes none); nothing falls
    back to another layout.  Decode, the experts and a block under the
    SSM chunk run: ``test_torch_sp_decode.py``, ``test_torch_sp_moe.py``."""
    kw = dict(device="cpu", layout="fsdp_sp", grid=_grid())
    cfg = get_reduced("stablelm-1.6b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    fsdp = FSDP(kw["grid"], params, "fsdp_sp", cfg)
    with pytest.raises(NotImplementedError, match="ragged"):
        prefill(fsdp.shard_tree(params), cfg,
                make_batch(cfg, 2, 64, 0, device="cpu"), 64,
                lengths=torch.tensor([64, 40]), fsdp=fsdp)

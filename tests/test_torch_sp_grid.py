"""``fsdp_sp`` on the grid ``{data: 2, model: 2}``: a world-4 gang (gloo on
the CPU, one thread a rank) of ``torch_sp_worker.py``, reduced f32
stablelm and mamba2, each rank on its data row's two rows and its model
coordinate's block of the sequence.  Held against the port's world-1
step on the same weights and global batch (tolerances as
``test_torch_sp_gang.py``):

* the loss, the gradients and an AdamW and a LAMB step;
* ``fsdp2`` storage: a leaf split over both axes is held in ``D*M``
  blocks, rank ``d*M + m`` holding block ``d*M + m`` (JAX's order for a
  tuple axis), and gathered over the world;
* the leaves replicated over model (the norms; mamba2's ``A_log``,
  ``D``, ``dt_bias``): each rank's gradient, as the step returns it,
  equals world 1's whole gradient, so it was reduced over both the data
  and the model group (one block of the sequence alone, or one data row
  alone, gives another number);
* each rank's bytes by mechanism equal ``sp_bytes`` for its two rows.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.sp import sp_bytes  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_one_thread import one_thread  # noqa: E402,F401
import sp_gang_common as C  # noqa: E402
import torch_sp_worker as W  # noqa: E402
import tp_gang_common as TC  # noqa: E402

CASES = W.CASES["world4"]
IDS = [a for a, _, _ in CASES]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp_grid")
    C.start(work, "world4", 4)
    return work


@pytest.fixture(scope="module")
def world1(gang):
    return {arch: C.world1(gang, arch, False) for arch, _, _ in CASES}


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_loss_grads_and_steps_equal_world1(gang, world1, arch, mesh, serve):
    want = world1[arch]
    for rank in range(4):
        got, info = C.load(gang, rank, arch, mesh)
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=TC.LOSS_RTOL)
        for key, w in want["grad"].items():
            TC.close(got[f"grad/{key}"], w, f"{arch} grad {key}")
        grads = {k[len("grad/"):]: v for k, v in got.items()
                 if k.startswith("grad/")}
        for name in (get_reduced(arch).optimizer, "lamb"):
            np.testing.assert_allclose(info[name]["loss"],
                                       want[name]["loss"],
                                       rtol=TC.LOSS_RTOL)
            TC.close(info[name]["grad_norm"], want[name]["grad_norm"],
                     f"{arch} {name} grad_norm")
            for key, w in C.update(gang, arch, name, grads).items():
                TC.close(got[f"{name}/{key}"], w, f"{arch} {name} {key}")
        assert info["round_trip_bitwise"]


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_fsdp2_blocks_in_rank_order(gang, arch, mesh, serve):
    cfg = get_reduced(arch)
    params = params_from_flat(dict(np.load(gang / f"{arch}.params.npz")),
                              cfg, device="cpu")
    leaves = tree_leaves(params)
    specs = tree_leaves(rules.param_shardings(params, mesh, "fsdp_sp"))
    for rank in range(4):
        got, info = C.load(gang, rank, arch, mesh)
        assert info["coords"] == {"data": rank // 2, "model": rank % 2}
        assert info["groups"]["world"] == [0, 1, 2, 3]
        i = info["fsdp2_leaf"]
        dim = specs[i].index(("data", "model"))
        assert info["axes"][i] == "plane"
        whole = leaves[i].numpy()
        size = whole.shape[dim] // 4
        np.testing.assert_array_equal(
            got["fsdp2_block"],
            np.take(whole, range(rank * size, (rank + 1) * size), axis=dim))
        assert all((a == "plane") == (("data", "model") in s)
                   for a, s in zip(info["axes"], specs))


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_replicated_grads_reduced_over_both_groups(gang, world1, arch, mesh,
                                                   serve):
    want = world1[arch]["grad_leaves"]
    for rank in range(4):
        got, info = C.load(gang, rank, arch, mesh)
        local = {int(k.split("/")[1]): v for k, v in got.items()
                 if k.startswith("local_grad/")}
        # norms everywhere, and mamba2's per-head vectors
        assert len(local) >= (4 if arch.startswith("mamba2") else 5)
        for i, g in local.items():
            assert info["reduce"][i] == ["data", "model"]
            TC.close(g, want[i].numpy(), f"{arch} leaf {i}")


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_bytes_are_the_shape_count(gang, arch, mesh, serve):
    cfg = get_reduced(arch)
    want = sp_bytes(cfg, W.B // 2, W.S, "train", 2, 4)
    for rank in range(4):
        _, info = C.load(gang, rank, arch, mesh)
        assert {k: info["bytes"].get(k, 0.0) for k in want} == want
        assert info["bytes"]["replicated_allreduce"] > 0

"""``fsdp_tp`` on four ranks: a world-4 gang (gloo on the CPU, one
thread a rank) of ``torch_tp_worker.py`` runs reduced f32 stablelm and
qwen3-moe on the grid ``{data: 2, model: 2}`` (each rank a
``(data, model)`` block of the two-axis leaves, a data row's rows, the
reductions over data and over model apart), and stablelm and mamba2 on
``{model: 4}``, where a rank's model block is not whole heads: stablelm's
two kv heads and mamba2's one B/C group each span two ranks, so ``wk``,
``wv``, ``in_B``, ``in_C`` and the conv weights are gathered over
``model`` and sliced.  Held, as in ``test_torch_tp_gang.py``, against the
port's world-1 step on the same weights and global batch (under the
mesh's ctx: qwen3-moe's two batch groups are the data rows' MoE dispatch
groups), the rules' block shapes, the ``tp_allreduce`` shape count, and
the reference's ``build_train(cfg, mesh, "fsdp_tp")`` on a host mesh
``(data 2, model 2)`` of four CPU devices.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.models.model import init_decode_state  # noqa: E402
from repro_torch.sharding.tp import (tp_allreduce_bytes,  # noqa: E402
                                     tp_state_bytes)
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_one_thread import one_thread  # noqa: E402,F401
import torch_tp_worker as W  # noqa: E402
import tp_gang_common as C  # noqa: E402

CASES = W.CASES["world4"]
IDS = [W.tag(a, m) for a, m, _ in CASES]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_grid")
    C.start(work, "world4", 4, 4)
    return work


@pytest.fixture(scope="module")
def world1(gang):
    return {W.tag(arch, mesh): C.world1(gang, arch, mesh, serve)
            for arch, mesh, serve in CASES}


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_loss_grads_and_steps_equal_world1(gang, world1, arch, mesh, serve):
    want = world1[W.tag(arch, mesh)]
    for rank in range(4):
        got, info = C.load(gang, rank, arch, mesh)
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=C.LOSS_RTOL)
        for key, w in want["grad"].items():
            C.close(got[f"grad/{key}"], w, f"{arch} grad {key}")
        grads = {k[len("grad/"):]: v for k, v in got.items()
                 if k.startswith("grad/")}
        for name in (get_reduced(arch).optimizer, "lamb"):
            np.testing.assert_allclose(info[name]["loss"],
                                       want[name]["loss"], rtol=C.LOSS_RTOL)
            C.close(info[name]["grad_norm"], want[name]["grad_norm"],
                    f"{arch} {name} grad_norm")
            for key, w in C.update(gang, arch, name, grads).items():
                C.close(got[f"{name}/{key}"], w, f"{arch} {name} {key}")
        assert info["round_trip_bitwise"]
        if serve:
            for i, w in enumerate(want["logits"]):
                C.close(got[f"logits/{i}"], w.numpy(), f"{arch} logits {i}")
            for when in ("prefill_state", "decode_state"):
                for k, w in want[when].items():
                    C.close(got[f"{when}/{k}"], w.numpy(),
                            f"{arch} {when} {k}")


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_blocks_groups_and_bytes(gang, arch, mesh, serve):
    """Each rank's coordinates and groups (row-major: rank ``d*M + m``),
    its block shapes by the rules, and its ``tp_allreduce`` bytes the
    shape count over its data row's rows."""
    cfg = get_reduced(arch)
    params = params_from_flat(dict(np.load(gang / f"{arch}.params.npz")),
                              cfg, device="cpu")
    specs = tree_leaves(rules.param_shardings(params, mesh, "fsdp_tp"))
    want = [list(rules.shard_shape(t.shape, s, mesh))
            for t, s in zip(tree_leaves(params), specs)]
    D, M = mesh.get("data", 1), mesh["model"]
    for rank in range(4):
        _, info = C.load(gang, rank, arch, mesh)
        d, m = divmod(rank, M)
        assert info["coords"] == ({"data": d, "model": m} if D > 1
                                  else {"model": m})
        assert info["groups"] == {
            "data": [i * M + m for i in range(D)],
            "model": [d * M + i for i in range(M)]}
        assert info["shard_shapes"] == want == info["grad_shapes"]
        assert info["bytes"]["tp_allreduce"] == tp_allreduce_bytes(
            cfg, W.B // D, W.S, "train", M, 4)
        if D > 1:
            assert info["bytes"]["grad_reducescatter"] > 0
        if serve:
            assert info["decode_bytes"]["tp_allreduce"] == \
                tp_allreduce_bytes(cfg, W.B, 1, "decode", M, 4)
            # the decode state: the rules' block, its bytes by mechanism
            # the shape count
            whole = init_decode_state(cfg, W.B, W.S + W.DECODE,
                                      device="meta")
            specs = rules.decode_state_shardings(whole, mesh, "fsdp_tp")
            assert info["state_shapes"] == {
                k: list(rules.shard_shape(t.shape, specs[k], mesh))
                for k, t in whole.items()}
            assert info["state_bytes"]["decode"] == \
                rules.per_device_bytes(whole, specs, mesh)
            for kind in ("prefill", "decode"):
                count = tp_state_bytes(cfg, W.B, W.S + W.DECODE, kind, M,
                                       4)
                assert {k: info[f"{kind}_bytes"].get(k, 0.0)
                        for k in count} == count
            # the straddling leaves, gathered over model
            assert info["bytes"]["tp_weights"] > 0


@pytest.mark.parametrize("arch,mesh,serve", W.REF["world4"],
                         ids=IDS[:len(W.REF["world4"])])
def test_matches_the_reference_fsdp_tp_step(gang, arch, mesh, serve):
    """The reference's ``build_train`` on a ``(data 2, model 2)`` host
    mesh: loss and ``grad_norm`` before its update."""
    ref = json.loads((gang / f"ref.{W.tag(arch, mesh)}.json").read_text())
    for rank in range(4):
        _, info = C.load(gang, rank, arch, mesh)
        got = info[get_reduced(arch).optimizer]
        np.testing.assert_allclose(got["loss"], ref["loss"],
                                   rtol=C.LOSS_RTOL)
        C.close(got["grad_norm"], ref["grad_norm"], f"{arch} grad_norm")

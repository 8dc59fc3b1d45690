"""``fsdp_tp`` on the grid ``{model: 2}``: a world-2 gang (gloo on the
CPU, one thread a rank) of ``torch_tp_worker.py`` computes, for reduced
f32 stablelm, mamba2, qwen3-moe and jamba (the hybrid), the
tensor-parallel loss and gradients, an AdamW and a LAMB step, the
flat-key round trip, a prefill and four greedy decode steps; then, for
the serve-only cases (``SERVE``: a kv head both ranks share, the
attention whole, a cache the axis does not divide), the prefill and
decode steps alone.  The decode state is the rules' block in every case
(mamba2's one SSM group: fewer groups than ranks).  Held against:

* the port's world-1 step on the same weights and global batch: the loss
  (rtol 1e-5), the gradients and the steps' loss and ``grad_norm`` (atol
  1e-5, rtol 1e-4: f32 partial sums added in another order); both steps'
  updates against world 1's update by the gang's own gradients; the
  prefill's and every decode step's whole logits, and the decode state
  after the prefill and after the last step (gathered from the ranks'
  heads and channels), within the same tolerance;
* the rules: each rank holds exactly its spec's block of each leaf on
  ``{model: 2}``, its gradients come back in the same shapes, and its
  decode state is exactly its ``decode_state_shardings`` block (its
  cache slots of every kv head, its SSM heads and conv channels), in
  shape and in bytes, after the prefill and after the last step;
* the shape count: each rank's ``tp_allreduce`` bytes in the step, the
  prefill and a decode step equal :func:`repro_torch.sharding.tp.
  tp_allreduce_bytes`, and the decode state's mechanisms (the prefill's
  ``state_reshard``; a decode step's ``qkv_allgather``,
  ``softmax_combine``, ``xbc_allgather``, ``conv_allgather``) equal
  :func:`repro_torch.sharding.tp.tp_state_bytes`, to the byte;
* the reference's own ``build_train(cfg, mesh, "fsdp_tp")`` on a host
  mesh ``(data 1, model 2)`` of two CPU devices, in a subprocess
  (``jax_tp_step.py``), from the same weights and batch: its loss and
  ``grad_norm`` before its update; and its ``build_prefill`` and
  ``build_decode(cfg, mesh, "fsdp_tp", ...)`` on the same mesh: every
  serving case's prefill and decode logits.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.data.inputs import make_batch  # noqa: E402
from repro_torch.distributed import init_distributed  # noqa: E402
from repro_torch.launch.steps import build_train  # noqa: E402
from repro_torch.models.model import init_params, prefill  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.fsdp import FSDP  # noqa: E402
from repro_torch.sharding.grid import RankGrid  # noqa: E402
from repro_torch.models.model import init_decode_state  # noqa: E402
from repro_torch.sharding.tp import (STATE_MECHANISMS,  # noqa: E402
                                     tp_allreduce_bytes, tp_state_bytes)
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_one_thread import one_thread  # noqa: E402,F401
import torch_tp_worker as W  # noqa: E402
import tp_gang_common as C  # noqa: E402

CASES = W.CASES["model2"]
IDS = [a for a, _, _ in CASES]
SERVING = W.serve_cases("model2")
SERVE_IDS = [c.name for c in SERVING]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_gang")
    C.start(work, "model2", 2, 2)
    return work


@pytest.fixture(scope="module")
def world1(gang):
    return {(arch, W.tag(arch, mesh)): C.world1(gang, arch, mesh, serve)
            for arch, mesh, serve in CASES}


@pytest.fixture(scope="module")
def world1_serve(gang):
    return {c.name: C.world1_serve_case(gang, c) for c in W.SERVE["model2"]}


def _state_close(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        C.close(got[k], w.numpy(), f"{what} {k}")


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_loss_grads_and_steps_equal_world1(gang, world1, arch, mesh, serve):
    want = world1[(arch, W.tag(arch, mesh))]
    for rank in range(2):
        got, info = C.load(gang, rank, arch, mesh)
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   rtol=C.LOSS_RTOL)
        for key, w in want["grad"].items():
            C.close(got[f"grad/{key}"], w, f"{arch} grad {key}")
        grads = {k[len("grad/"):]: v for k, v in got.items()
                 if k.startswith("grad/")}
        for name in (get_reduced(arch).optimizer, "lamb"):
            metrics = want[name]
            np.testing.assert_allclose(info[name]["loss"], metrics["loss"],
                                       rtol=C.LOSS_RTOL)
            C.close(info[name]["grad_norm"], metrics["grad_norm"],
                    f"{arch} {name} grad_norm")
            for key, w in C.update(gang, arch, name, grads).items():
                C.close(got[f"{name}/{key}"], w, f"{arch} {name} {key}")
        assert info["round_trip_bitwise"]


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_prefill_and_decode_equal_world1(gang, world1, arch, mesh, serve):
    want = world1[(arch, W.tag(arch, mesh))]
    for rank in range(2):
        got, _ = C.load(gang, rank, arch, mesh)
        _prefill_and_decode_close(got, want, arch)


def _prefill_and_decode_close(got, want, what):
    for i, w in enumerate(want["logits"]):
        C.close(got[f"logits/{i}"], w.numpy(), f"{what} logits {i}")
    for when in ("prefill_state", "decode_state"):
        _state_close({k.split("/", 1)[1]: v for k, v in got.items()
                      if k.startswith(when + "/")}, want[when],
                     f"{what} {when}")


@pytest.mark.parametrize("case", W.SERVE["model2"],
                         ids=[c.name for c in W.SERVE["model2"]])
def test_serve_cases_equal_world1(gang, world1_serve, case):
    """A kv head both ranks share, the attention whole, a cache the axis
    does not divide: the prefill's and every decode step's logits and
    the state gathered whole against world 1."""
    for rank in range(2):
        got, _ = C.load(gang, rank, case.name, case.mesh)
        _prefill_and_decode_close(got, world1_serve[case.name], case.name)


def _rules_state(cfg, cache: int, mesh: dict):
    """The rules' per-device blocks of the whole decode state: shapes by
    leaf, and bytes."""
    whole = init_decode_state(cfg, W.B, cache, device="meta")
    specs = rules.decode_state_shardings(whole, mesh, "fsdp_tp")
    shapes = {k: list(rules.shard_shape(t.shape, specs[k], mesh))
              for k, t in whole.items()}
    return shapes, rules.per_device_bytes(whole, specs, mesh)


@pytest.mark.parametrize("case", SERVING, ids=SERVE_IDS)
def test_decode_state_is_the_rules_block(gang, case):
    """Each rank's decode state after the prefill and after the last
    step: exactly its ``decode_state_shardings`` block, in shape and in
    bytes (every kv head over its cache slots, its SSM heads, its conv
    channels; whole where the axis does not divide); a zeroed state of
    the grid has the same shapes."""
    cfg = W.config(get_reduced, case.arch, case.heads)
    shapes, nbytes = _rules_state(cfg, case.cache, case.mesh)
    split = {k for k, v in shapes.items()
             if v != list(init_decode_state(cfg, W.B, case.cache,
                                            device="meta")[k].shape)}
    # the odd cache keeps K/V whole; every other leaf splits
    assert split == (set(shapes) - {"k", "v"} if case.cache % 2
                     else set(shapes))
    for rank in range(2):
        _, info = C.load(gang, rank, case.name, case.mesh)
        assert info["state_shapes"] == shapes == info["init_state_shapes"]
        assert info["state_bytes"] == {"prefill": nbytes, "decode": nbytes}


@pytest.mark.parametrize("case", SERVING, ids=SERVE_IDS)
def test_decode_state_bytes_are_the_shape_count(gang, case):
    """The prefill's ``state_reshard`` and one decode step's
    ``qkv_allgather``, ``softmax_combine``, ``xbc_allgather`` and
    ``conv_allgather``: each rank's bytes equal ``tp_state_bytes``, to
    the byte (f32), and its ``tp_allreduce`` ``tp_allreduce_bytes``."""
    cfg = W.config(get_reduced, case.arch, case.heads)
    for rank in range(2):
        _, info = C.load(gang, rank, case.name, case.mesh)
        for kind in ("prefill", "decode"):
            got = info[f"{kind}_bytes"]
            want = tp_state_bytes(cfg, W.B, case.cache, kind, 2, 4)
            assert {k: got.get(k, 0.0) for k in STATE_MECHANISMS} == want
            assert got["tp_allreduce"] == tp_allreduce_bytes(
                cfg, W.B, W.S if kind == "prefill" else 1, kind, 2, 4)
        assert any(info["decode_bytes"].get(k) for k in STATE_MECHANISMS)


@pytest.mark.parametrize("case", W.REF_SERVE["model2"],
                         ids=[c.name for c in W.REF_SERVE["model2"]])
def test_decode_matches_the_reference_fsdp_tp(gang, case):
    """The reference's ``build_prefill`` and ``build_decode(cfg, mesh,
    "fsdp_tp", ...)`` on a ``(data 1, model 2)`` host mesh, from the
    same weights and tokens: the prefill's and every decode step's
    logits, within the gang's tolerance."""
    ref = np.load(gang / f"ref.{W.tag(case.name, case.mesh)}.serve.npz")
    for rank in range(2):
        got, _ = C.load(gang, rank, case.name, case.mesh)
        for i, want in enumerate(ref["logits"]):
            C.close(got[f"logits/{i}"], want, f"{case.name} logits {i}")


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_each_rank_holds_its_block(gang, arch, mesh, serve):
    """Block shapes by the rules on ``{model: 2}``, gradients in the same
    shapes, and the decode state the rules' block
    (``decode_state_shardings``)."""
    cfg = get_reduced(arch)
    params = params_from_flat(dict(np.load(gang / f"{arch}.params.npz")),
                              cfg, device="cpu")
    specs = tree_leaves(rules.param_shardings(params, mesh, "fsdp_tp"))
    leaves = tree_leaves(params)
    want = [list(rules.shard_shape(t.shape, s, mesh))
            for t, s in zip(leaves, specs)]
    assert sum(w != list(t.shape) for w, t in zip(want, leaves)) > 4
    for rank in range(2):
        _, info = C.load(gang, rank, arch, mesh)
        assert info["coords"] == {"model": rank}
        assert info["groups"] == {"data": [rank], "model": [0, 1]}
        assert info["shard_shapes"] == want
        assert info["grad_shapes"] == want
        shapes, _ = _rules_state(cfg, W.S + W.DECODE, mesh)
        assert info["state_shapes"] == info["init_state_shapes"] == shapes


@pytest.mark.parametrize("arch,mesh,serve", CASES, ids=IDS)
def test_tp_allreduce_bytes_are_the_shape_count(gang, arch, mesh, serve):
    """The step (forward, remat, backward), the prefill and one decode
    step: each rank's ``tp_allreduce`` bytes, f32 throughout."""
    cfg = get_reduced(arch)
    for rank in range(2):
        _, info = C.load(gang, rank, arch, mesh)
        assert info["bytes"]["tp_allreduce"] == tp_allreduce_bytes(
            cfg, W.B, W.S, "train", 2, 4)
        assert info["prefill_bytes"]["tp_allreduce"] == tp_allreduce_bytes(
            cfg, W.B, W.S, "prefill", 2, 4)
        assert info["decode_bytes"]["tp_allreduce"] == tp_allreduce_bytes(
            cfg, W.B, 1, "decode", 2, 4)
        # nothing over data on a grid of one data row
        assert not {"fsdp_allgather", "grad_reducescatter"} & set(
            info["bytes"])


@pytest.mark.parametrize("arch,mesh,serve", W.REF["model2"],
                         ids=IDS[:len(W.REF["model2"])])
def test_matches_the_reference_fsdp_tp_step(gang, arch, mesh, serve):
    """The reference's ``build_train`` on a ``(data 1, model 2)`` host
    mesh: loss and ``grad_norm`` before its update."""
    import json
    ref = json.loads((gang / f"ref.{W.tag(arch, mesh)}.json").read_text())
    _, info = C.load(gang, 0, arch, mesh)
    got = info[get_reduced(arch).optimizer]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=C.LOSS_RTOL)
    C.close(got["grad_norm"], ref["grad_norm"], f"{arch} grad_norm")


def _dist(world, rank):
    from repro_torch.distributed import DistContext
    return DistContext(world_size=world, rank=rank, coordinator=None,
                       device=torch.device("cpu"), backend=None)


@pytest.mark.parametrize("layout,error", [("fsdp_sp", NotImplementedError),
                                          ("dp", ValueError)])
def test_a_model_axis_runs_only_fsdp_tp(layout, error):
    """What a model axis does not run raises: ``fsdp_sp``'s prefill with
    ragged lengths (its train, prefill and decode steps run every arch,
    see ``test_torch_sp_*.py``), and ``dp``, which would run duplicated
    ranks; a grid of one rank is still the ``dp`` step."""
    grid = RankGrid({"data": 1, "model": 2}, _dist(2, 1))
    if layout == "fsdp_sp":
        cfg = get_reduced("qwen3-moe-30b-a3b")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        fsdp = FSDP(grid, params, layout, cfg)
        with pytest.raises(error, match="ragged"):
            prefill(fsdp.shard_tree(params), cfg,
                    make_batch(cfg, 2, 16, 0, device="cpu"), 16,
                    lengths=torch.tensor([16, 9]), fsdp=fsdp)
    else:
        with pytest.raises(error, match="duplicated"):
            build_train(get_reduced("stablelm-1.6b"), 2, 16, device="cpu",
                        layout=layout, grid=grid)
    one = RankGrid({"data": 1}, init_distributed(1, device="cpu"))
    step, (state, batch) = build_train(get_reduced("stablelm-1.6b"), 2, 16,
                                       device="cpu", layout=layout,
                                       grid=one)
    assert torch.isfinite(step(state, batch)[1]["loss"])

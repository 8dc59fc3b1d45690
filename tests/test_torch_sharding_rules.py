"""``repro_torch.sharding.rules`` against the reference's rules, spec for
spec: every arch on the grids 16x16, 2x16x16, ``{data: 2}`` and ``{data:
2, model: 2}``, under ``dp``, ``fsdp_tp`` and ``fsdp_sp``.  Each
parameter's, AdamW and SGDM moment's, decode-state leaf's and batch
array's spec (batch 1 too) equals the reference's ``NamedSharding.spec``
(the reference's on its fake meshes of ``tests/test_sharding.py``), less
the leading period dim of a stacked ``periods/slot{j}`` leaf, which the
port holds as ``layers[p*P + j]``.  The bytes one device holds under the
port's specs equal the sum of the reference's ``shard_shape``s.  Then
the ctx and the grid: ``ShardCtx`` readers, a rank's coordinates and
groups on ``{data: 2, model: 2}``, and a grid with a pod axis above 1
raising."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import inputs as JI  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.optim import get_optimizer as jax_optimizer  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.data.inputs import input_specs  # noqa: E402
from repro_torch.distributed import DistContext  # noqa: E402
from repro_torch.launch.steps import shard_ctx_for, state_shardings  # noqa: E402
from repro_torch.models.model import (init_decode_state,  # noqa: E402
                                      param_specs, period_len)
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.sharding import ShardCtx, current_ctx, rules, use_ctx  # noqa: E402
from repro_torch.sharding.grid import RankGrid  # noqa: E402

from test_sharding import _fake_mesh  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

GRIDS = {"16x16": {"data": 16, "model": 16},
         "2x16x16": {"pod": 2, "data": 16, "model": 16},
         "data2": {"data": 2},
         "data2xmodel2": {"data": 2, "model": 2}}
LAYOUTS = ("dp", "fsdp_tp", "fsdp_sp")
DECODE = (128, 32768)


@functools.lru_cache(maxsize=None)
def _mesh(grid):
    dims = GRIDS[grid]
    return _fake_mesh(tuple(dims.values()), tuple(dims))


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    cfg = jax_config(arch)
    params = jax_param_specs(cfg)
    trees = {"params": params}
    for name in ("adamw", "sgdm"):
        trees[name] = jax.eval_shape(jax_optimizer(name).init, params)
    if not cfg.is_encoder_only:
        trees["decode"] = jax.eval_shape(
            lambda: JM.init_decode_state(cfg, *DECODE))
    return trees


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = get_config(arch)
    params = param_specs(cfg)
    trees = {"params": params}
    for name in ("adamw", "sgdm"):
        trees[name] = get_optimizer(name).init(params)
    if not cfg.is_encoder_only:
        trees["decode"] = init_decode_state(cfg, *DECODE, device="meta")
    return trees


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _ref_specs(tree, shardings):
    """{path: (shape, itemsize, spec)} of a reference tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree_util.tree_leaves(shardings)
    return {_key(p): (tuple(l.shape), np.dtype(l.dtype).itemsize,
                      tuple(sh.spec), sh) for (p, l), sh in zip(leaves, shs)}


def _ref_key(path: str, P: int):
    """The reference's key of a port path, and whether it is stacked."""
    parts = path.split("/")
    if "layers" not in parts:
        return path, False
    i = parts.index("layers")
    layer = int(parts[i + 1])
    return "/".join(parts[:i] + ["periods", f"slot{layer % P}"]
                    + parts[i + 2:]), True


def _pairs(arch, grid, layout, what):
    """(port path, port spec, the reference's spec less the period dim)
    for every port leaf of ``what``."""
    mesh, dims = _mesh(grid), GRIDS[grid]
    ref_tree = _ref_trees(arch)[what]
    port_tree = _port_trees(arch)[what]
    if what == "decode":
        ref = _ref_specs(ref_tree, JR.decode_state_shardings(ref_tree, mesh,
                                                             layout))
        port = rules.decode_state_shardings(port_tree, dims, layout)
    else:
        ref = _ref_specs(ref_tree, JR.param_shardings(ref_tree, mesh,
                                                      layout))
        port = rules.param_shardings(port_tree, dims, layout)
    return ref, port, port_tree


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_the_reference(arch, grid, layout):
    P = period_len(get_config(arch))
    dims = GRIDS[grid]
    for what in ("params", "adamw", "sgdm", "decode"):
        if what not in _port_trees(arch):
            continue
        ref, port, port_tree = _pairs(arch, grid, layout, what)
        flat = {}
        rules.map_with_path(lambda p, s: flat.__setitem__(p, s), port)
        if what == "decode":
            # one stacked tensor per name: every slot of that kind agrees
            for name, spec in flat.items():
                slots = [v[2] for k, v in ref.items()
                         if k.rsplit("/", 1)[-1] == name]
                assert slots and all(s == spec for s in slots), (name, spec,
                                                                 slots)
        else:
            assert {_ref_key(p, P)[0] for p in flat} == set(ref)
            for path, spec in flat.items():
                key, stacked = _ref_key(path, P)
                want = ref[key][2][1:] if stacked else ref[key][2]
                assert spec == want, (what, path, spec, want)
        # the bytes one device holds
        want = sum(math.prod(sh.shard_shape(shape)) * size
                   for shape, size, _, sh in ref.values())
        assert rules.per_device_bytes(port_tree, port, dims) == want, what
    # the batch arrays, the shape's global batch and batch 1
    for batch in (256, 32, 1):
        port = input_specs(get_config(arch), batch, 4096)
        ref = JI.input_specs(jax_config(arch), batch, 4096)
        assert set(port) == set(ref)
        for name, t in port.items():
            want = JR.batch_sharding(_mesh(grid), t.dim(), 0, batch).spec
            got = rules.batch_sharding(dims, t.dim(), 0, batch)
            assert got == tuple(want) + (None,) * (t.dim() - len(want)), (
                name, batch, got, want)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_logical_axes_and_state_shardings(grid):
    dims = GRIDS[grid]
    for layout in LAYOUTS:
        assert rules.logical_axes(dims, layout) == JR.logical_axes(
            _mesh(grid), layout)
        assert rules.batch_axes(dims) == JR.batch_axes(_mesh(grid))
        ctx = shard_ctx_for(dims, layout)
        assert ctx.logical == rules.logical_axes(dims, layout)
    cfg = get_config("stablelm-1.6b")
    st = state_shardings(cfg, dims, "fsdp_tp")
    assert st.opt_state["m"] == st.params == st.opt_state["v"]


def test_ctx_is_thread_local_and_nests():
    import threading
    a = ShardCtx({"data": 2, "model": 4}, {"seq": "model", "batch": "data"})
    seen = []
    with use_ctx(a):
        assert current_ctx() is a and a.extent("seq") == 4
        assert a.extent("batch") == 2 and a.extent("vocab") == 1
        with use_ctx(None):
            assert current_ctx() is None
        t = threading.Thread(target=lambda: seen.append(current_ctx()))
        t.start()
        t.join()
        assert current_ctx() is a
    assert current_ctx() is None and seen == [None]
    assert ShardCtx(None, {"seq": "model"}).extent("seq") == 1


def _dist(world, rank):
    return DistContext(world_size=world, rank=rank, coordinator=None,
                       device=torch.device("cpu"), backend=None)


def test_grid_coordinates_and_the_missing_axes():
    grid = RankGrid({"data": 4}, _dist(4, 3))
    assert grid.coords == {"data": 3}
    assert grid.shard_of("data") == (3, 4)
    assert grid.shard_of(None) == (0, 1)
    with_model = RankGrid({"data": 4, "model": 1}, _dist(4, 2))
    assert with_model.shard_of(("data", "model")) == (2, 4)
    for mesh in ({"data": 2, "model": 2}, {"pod": 2, "data": 2}):
        if "pod" in mesh:
            # the pod axis runs: rank 3 = p 1, d 1; its pod group the
            # ranks of its data coordinate, its batch group every rank
            pod = RankGrid(mesh, _dist(4, 3))
            assert pod.coords == {"pod": 1, "data": 1}
            assert (pod.group("pod").ranks, pod.group("pod").index) == (
                (1, 3), 1)
            assert pod.group("batch").ranks == (0, 1, 2, 3)
            assert pod.group("plane").ranks == (2, 3)
            continue
        # rank 3 = d 1, m 1 (row-major); its data group is its model
        # column, its model group its data row
        tp = RankGrid(mesh, _dist(4, 3))
        assert tp.coords == {"data": 1, "model": 1}
        assert tp.shard_of("model") == (1, 2)
        assert tp.shard_of(("data", "model")) == (3, 4)
        assert (tp.group("data").ranks, tp.group("data").index) == ((1, 3), 1)
        assert (tp.group("model").ranks, tp.group("model").index) == ((2, 3),
                                                                      1)
    with pytest.raises(ValueError, match="has 2 ranks"):
        RankGrid({"data": 2}, _dist(4, 0))


def test_collective_bytes_follow_the_ring_convention():
    """A gather or reduce-scatter of F full bytes counts (N-1)/N * F for
    the rank, an all-reduce twice that, each under its mechanism (the
    analytic model's names), with one call each."""
    d = _dist(4, 1)
    d._count("fsdp_allgather", 400, 1)
    d._count("fsdp_allgather", 400, 1)
    d._count("grad_reducescatter", 400, 1)
    d._count("replicated_allreduce", 40, 2)
    assert d.collective_bytes == {"fsdp_allgather": 600.0,
                                  "grad_reducescatter": 300.0,
                                  "replicated_allreduce": 60.0}
    assert d.collective_calls == {"fsdp_allgather": 2,
                                  "grad_reducescatter": 1,
                                  "replicated_allreduce": 1}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind,arch", [("train", "stablelm-1.6b"),
                                       ("train", "jamba-1.5-large-398b"),
                                       ("decode", "glm4-9b")])
def test_dry_run_sharded_bytes_are_the_reference_shards(kind, arch, layout):
    """The dry run's per-device bytes on the production mesh: the sums of
    the reference's ``shard_shape``s of the same trees."""
    from repro_torch.launch.dryrun import sharded_bytes
    mesh = _mesh("16x16")
    from repro.launch.steps import pick_optimizer as jax_pick
    got = sharded_bytes(get_config(arch), kind, *DECODE, GRIDS["16x16"],
                        layout)
    trees = _ref_trees(arch)

    def ref_bytes(tree, shardings):
        return sum(math.prod(sh.shard_shape(shape)) * size for shape, size,
                   _, sh in _ref_specs(tree, shardings).values())

    p = ref_bytes(trees["params"], JR.param_shardings(trees["params"], mesh,
                                                      layout))
    assert got["params"] == p
    if kind == "train":
        # the step's optimizer: bf16 moments above 20e9 parameters
        opt = jax.eval_shape(jax_pick(jax_config(arch)).init,
                             trees["params"])
        assert got["grads"] == p
        assert got["optimizer_state"] == ref_bytes(
            opt, JR.param_shardings(opt, mesh, layout))
    else:
        assert got["decode_state"] == ref_bytes(
            trees["decode"], JR.decode_state_shardings(trees["decode"],
                                                       mesh, layout))

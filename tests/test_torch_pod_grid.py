"""The ``pod`` axis of :class:`repro_torch.sharding.grid.RankGrid`, with no
processes: every rank of ``{pod: 2, data: 2, model: 2}`` over a meta
rank context (:func:`repro_torch.distributed.context.meta_context`), its
groups (``data`` and ``model`` within its pod, ``pod`` across the pods,
``batch`` the ranks that split the batch over ``(pod, data)``, ``plane``
its pod's ranks) and its rows, as the reference's ``batch_sharding``
places them (a batch of 1 replicated, a batch of 2 split over the pods
alone); the meta context's collectives (shapes, bytes and groups
counted, values never read); the FSDP storage's ``pod_gradsync`` leaves
and count from the shapes."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distributed.context import meta_context  # noqa: E402
from repro_torch.launch.steps import _rows  # noqa: E402
from repro_torch.models.model import param_specs  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.fsdp import FSDP  # noqa: E402
from repro_torch.sharding.grid import RankGrid, model_grid  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MESH = {"pod": 2, "data": 2, "model": 2}


def _grid(mesh, rank):
    n = 1
    for v in mesh.values():
        n *= v
    return RankGrid(mesh, meta_context(n, rank))


@pytest.mark.parametrize("rank", range(8))
def test_groups_of_every_rank(rank):
    """Rank ``r = p*4 + d*2 + m``: its data, model, pod, batch and plane
    groups' ranks in group order, and its index in each."""
    g = _grid(MESH, rank)
    p, d, m = rank // 4, rank // 2 % 2, rank % 2
    assert g.coords == {"pod": p, "data": d, "model": m}
    want = {"data": (4 * p + m, 4 * p + 2 + m),
            "model": (4 * p + 2 * d, 4 * p + 2 * d + 1),
            "pod": (2 * d + m, 4 + 2 * d + m),
            "batch": (m, 2 + m, 4 + m, 6 + m),
            "plane": tuple(range(4 * p, 4 * p + 4)),
            "world": tuple(range(8))}
    for axis, ranks in want.items():
        group = g.group(axis)
        assert group.ranks == ranks, axis
        assert group.index == ranks.index(rank), axis
    assert g.group("batch").index == 2 * p + d
    assert g.group("plane").index == 2 * d + m


@pytest.mark.parametrize("rank", range(8))
def test_rows_split_over_pod_and_data(rank):
    """A batch of 8 splits over the 4 ranks of (pod, data): the rank's
    block ``p*2 + d``, the model ranks holding the same rows."""
    g = _grid(MESH, rank)
    rows = {"tokens": torch.arange(8 * 3).reshape(8, 3)}
    block = 2 * g.coord("pod") + g.coord("data")
    assert g.batch_block(8) == (block, 4)
    got = _rows(rows, g, "train")["tokens"]
    assert torch.equal(got, rows["tokens"][2 * block:2 * block + 2])


@pytest.mark.parametrize("mesh,batch,want", [
    ({"data": 2, "model": 2}, 1, None),
    (MESH, 2, "pod"),
    (MESH, 1, None),
    (MESH, 4, ("pod", "data")),
])
def test_batch_fallback_is_the_reference_batch_sharding(mesh, batch, want):
    """A batch that does not split over ``(pod, data)`` keeps the axes of
    it whose running extent divides it (the reference's
    ``batch_sharding``): 1 row is replicated over a data extent of 2; 2
    rows split over the pods and are replicated over data."""
    assert rules.batch_sharding(mesh, 1, 0, batch) == (want,)
    n = 0
    for rank in range(4 if "pod" not in mesh else 8):
        g = _grid(mesh, rank)
        index, count = g.batch_block(batch)
        if want is None:
            assert (index, count) == (0, 1)
        elif want == "pod":
            assert (index, count) == (g.coord("pod"), 2)
        else:
            assert (index, count) == (g.group("batch").index, 4)
        x = {"tokens": torch.arange(batch)[:, None]}
        got = _rows(x, g)["tokens"][:, 0].tolist()
        assert got == list(range(index * batch // count,
                                 (index + 1) * batch // count))
        n += 1
    assert n


def test_train_rows_must_split_over_the_batch_group():
    """A train batch the batch group does not split raises: replicated
    rows would count twice in the loss."""
    g = _grid(MESH, 5)
    with pytest.raises(NotImplementedError, match="does not split"):
        _rows({"tokens": torch.zeros(2, 3)}, g, "train")


@pytest.mark.parametrize("pod,model,want", [
    (1, 2, {"data": 4, "model": 2}),
    (2, 2, {"pod": 2, "data": 2, "model": 2}),
    (2, 1, {"pod": 2, "data": 4}),
    (1, 1, {"data": 8}),
])
def test_model_grid_takes_a_pod_extent(pod, model, want):
    assert model_grid(meta_context(8, 3), model, pod).mesh == want


def test_meta_collectives_count_shapes_and_groups():
    """Shapes as the real collectives give them, bytes in the ring
    convention over the group's size, the group's ranks recorded;
    nothing reads a value."""
    g = _grid(MESH, 6)
    dist = g.dist
    x = torch.empty(3, 4, device="meta")
    out = dist.all_gather(x, 1, "fsdp_allgather", g.group("plane"))
    assert out.shape == (3, 16) and out.device.type == "meta"
    assert dist.reduce_scatter(out, 1, "grad_reducescatter",
                               g.group("plane")).shape == (3, 4)
    assert dist.all_to_all(x, "moe_alltoall", g.group("model")).shape == (
        3, 4)
    assert dist.all_reduce(x, "tp_allreduce", g.group("model")).shape == (
        3, 4)
    assert dist.allgather(torch.zeros(5, device="meta"),
                          g.group("batch")).shape == (4, 5)
    dist.allreduce_([x, x], "pod_gradsync", g.group("pod"))
    nbytes = 3 * 4 * 4
    assert dist.collective_bytes == {
        "fsdp_allgather": 4 * nbytes * 3 / 4,
        "grad_reducescatter": 4 * nbytes * 3 / 4,
        "moe_alltoall": nbytes / 2, "tp_allreduce": nbytes,
        "pod_gradsync": 2 * nbytes}
    assert dist.collective_groups["pod_gradsync"] == {(2, 6): 2 * nbytes}
    assert dist.collective_groups["fsdp_allgather"] == {
        (4, 5, 6, 7): 3 * nbytes}
    with pytest.raises(RuntimeError, match="meta"):
        dist.agree(0, "step")


@pytest.mark.parametrize("layout", ["fsdp_tp", "fsdp_sp"])
def test_pod_gradsync_leaves_and_count(layout):
    """Every leaf but those replicated over data alone (which the loss's
    all-reduce over the batch group sums) is summed over the pods; the
    count from the shapes is ``2 (P-1)/P`` of those blocks' bytes; the
    ``fsdp2`` leaves gather over the rank's pod (the plane)."""
    cfg = get_reduced("stablelm-1.6b")
    g = _grid(MESH, 7)
    params = param_specs(cfg)
    fsdp = FSDP(g, params, layout, cfg)
    blocks = fsdp.shard_tree(params)
    assert fsdp.pod_sync == [r != {"data"} for r in fsdp.reduce]
    held = sum(t.numel() * t.element_size()
               for t, s in zip(tree_leaves(blocks), fsdp.pod_sync) if s)
    assert held > 0
    assert fsdp.pod_gradsync_bytes(blocks) == held
    axes = set(tree_leaves(fsdp.axes)) - {None}
    assert axes == ({"data", "plane"} if layout == "fsdp_sp" else {"data"})
    one_pod = FSDP(_grid({"data": 2, "model": 2}, 3), params, layout, cfg)
    assert not any(one_pod.pod_sync)
    assert one_pod.pod_gradsync_bytes(blocks) == 0.0

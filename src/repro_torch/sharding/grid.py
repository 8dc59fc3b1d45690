"""The gang's ranks as a named grid (port-only).

The reference lays its devices out as a JAX mesh with named axes
(``pod``, ``data``, ``model``) and lets XLA place each shard.  The port's
gang is N processes (:mod:`repro_torch.distributed`), one tensor of its
own each; :class:`RankGrid` names them: rank r sits at the row-major
coordinates of r over the mesh's axes in the reference's order, so on
``{pod: P, data: D, model: M}`` rank ``r = p*D*M + d*M + m``.

Each rank has a :class:`repro_torch.distributed.context.Group` for each
of these sets of ranks:

* **data**: the D ranks of its pod and model column (the ranks that hold
  the same model block and split the pod's rows and the FSDP storage);
* **model**: the M ranks of its pod and data row (the ranks that hold
  the same rows and split the heads, experts and vocabulary, or under
  ``fsdp_sp`` the sequence);
* **pod**: the P ranks that share ``(d, m)``, the replicas of its blocks
  across the pods (the reference's pod axis is pure data parallelism:
  parameters replicated across pods);
* **batch**: the P*D ranks that share ``m``, in ``p*D + d`` order, the
  ranks that split the global batch (the reference's ``batch_axes``);
  :meth:`RankGrid.batch_block` is the rank's block of a batch, by the
  reference's ``batch_sharding``;
* **plane**: the D*M ranks of its pod, in ``d*M + m`` order: a leaf
  split over both axes (``fsdp_sp``'s ``fsdp2``) is gathered over it,
  its block index ``d*M + m``;
* **world**: every rank, the default group.

With one pod the plane is the world and the batch group the data group.
A set of ranks that spans the world takes the default group, which every
collective of :class:`repro_torch.distributed.DistContext` takes by
default; between 1 and the world, the grid makes one
``torch.distributed`` subgroup per set, every rank calling ``new_group``
for all of them in the same order (data, model, pod, batch, plane; a set
already made is not made again) before any collective.  A set of one
rank is the identity.  A grid over a :func:`repro_torch.distributed.
context.meta_context` makes no subgroup: its collectives are traced.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from repro_torch.distributed.context import Group
from repro_torch.sharding import rules
from repro_torch.sharding.rules import AxisVal

AXIS_ORDER = ("pod", "data", "model")
# the rank groups, in the order every rank creates them
GROUPS = ("data", "model", "pod", "batch", "plane")


class RankGrid:
    """One rank's place in a named grid of ``dist.world_size`` ranks.

    ``mesh`` is an axis-size dict whose product is the world size;
    ``dist`` the rank's :class:`repro_torch.distributed.DistContext`.
    :meth:`group` gives the rank's groups (the module's docstring)."""

    def __init__(self, mesh: Mapping[str, int], dist):
        unknown = set(mesh) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; the "
                             f"axes are {AXIS_ORDER}")
        self.mesh: Dict[str, int] = {a: int(mesh[a]) for a in AXIS_ORDER
                                     if a in mesh}
        if math.prod(self.mesh.values()) != dist.world_size:
            raise ValueError(f"grid {self.mesh} has "
                             f"{math.prod(self.mesh.values())} ranks, the "
                             f"world {dist.world_size}")
        self.dist = dist
        self.coords: Dict[str, int] = {}
        rest = dist.rank
        for axis in reversed(list(self.mesh)):
            rest, self.coords[axis] = divmod(rest, self.mesh[axis])
        self._groups = self._make_groups()

    def _members(self) -> Dict[str, list]:
        """Each kind of group's rank sets, in creation order."""
        P, D, M = (self.extent(a) for a in AXIS_ORDER)

        def r(p, d, m):
            return p * D * M + d * M + m

        return {
            "data": [tuple(r(p, d, m) for d in range(D))
                     for p in range(P) for m in range(M)],
            "model": [tuple(r(p, d, m) for m in range(M))
                      for p in range(P) for d in range(D)],
            "pod": [tuple(r(p, d, m) for p in range(P))
                    for d in range(D) for m in range(M)],
            "batch": [tuple(r(p, d, m) for p in range(P) for d in range(D))
                      for m in range(M)],
            "plane": [tuple(r(p, d, m) for d in range(D) for m in range(M))
                      for p in range(P)]}

    def _make_groups(self) -> Dict[str, Group]:
        world, rank = self.dist.world_size, self.dist.rank
        live = (self.dist.backend not in (None, "meta")
                and torch.distributed.is_initialized())
        members = self._members()
        made: Dict[tuple, object] = {}
        groups = {"world": self.dist.world}
        for kind in GROUPS:
            for ranks in members[kind]:
                if ranks not in made:
                    made[ranks] = None
                    if live and 1 < len(ranks) < world:
                        # every rank calls new_group for every set
                        made[ranks] = torch.distributed.new_group(
                            list(ranks))
                if rank in ranks:
                    groups[kind] = Group(ranks, ranks.index(rank),
                                         made[ranks])
        return groups

    @property
    def world_size(self) -> int:
        return self.dist.world_size

    @property
    def rank(self) -> int:
        return self.dist.rank

    @property
    def device(self):
        return self.dist.device

    def extent(self, axis: str) -> int:
        """The axis's size (1 for an axis the mesh does not name)."""
        return self.mesh.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Group:
        """The rank's ``"data"``, ``"model"``, ``"pod"``, ``"batch"``,
        ``"plane"`` or ``"world"`` group."""
        return self._groups[axis]

    def batch_block(self, batch: int) -> tuple:
        """``(index, count)``: the rank's block of a global batch of
        ``batch`` rows, by the reference's ``batch_sharding``: the batch
        over ``(pod, data)``, or over the axes of it whose running
        extent divides ``batch`` (a batch of 1 is replicated)."""
        spec = rules.batch_sharding(self.mesh, 1, 0, batch)
        return self.shard_of(spec[0])

    def shard_of(self, entry: AxisVal) -> tuple:
        """``(index, count)``: which of the ``count`` blocks of a dim
        whose spec entry is ``entry`` this rank holds (row-major over
        the entry's axes)."""
        if entry is None:
            return 0, 1
        names = (entry,) if isinstance(entry, str) else entry
        index, count = 0, 1
        for n in names:
            index = index * self.mesh[n] + self.coords[n]
            count *= self.mesh[n]
        return index, count


def data_grid(dist) -> RankGrid:
    """The gang's ranks on one data axis: ``{"data": world_size}``."""
    return RankGrid({"data": dist.world_size}, dist)


def model_grid(dist, model: int, pod: int = 1) -> RankGrid:
    """The gang's ranks on ``{"pod": pod, "data": world_size / (pod *
    model), "model": model}`` (an axis of 1 left out; a model and pod
    extent of 1 is :func:`data_grid`)."""
    if model < 1 or pod < 1 or dist.world_size % (model * pod):
        raise ValueError(f"a model extent of {model} and a pod extent of "
                         f"{pod} do not divide the world of "
                         f"{dist.world_size}")
    if model == pod == 1:
        return data_grid(dist)
    mesh = {"pod": pod, "data": dist.world_size // (model * pod),
            "model": model}
    return RankGrid({a: n for a, n in mesh.items()
                     if n > 1 or a == "data"}, dist)

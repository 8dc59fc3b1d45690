"""The gang's ranks as a named grid (port-only).

The reference lays its devices out as a JAX mesh with named axes
(``pod``, ``data``, ``model``) and lets XLA place each shard.  The port's
gang is N processes (:mod:`repro_torch.distributed`), one tensor of its
own each; :class:`RankGrid` names them: rank r sits at the row-major
coordinates of r over the mesh's axes in the reference's order, so on
``{data: D, model: M}`` rank ``r = d*M + m``.

Each axis gives every rank a :class:`repro_torch.distributed.context.
Group`: its **data** group is the D ranks of its model column (the ranks
that hold the same model block and split the batch), its **model** group
the M ranks of its data row (the ranks that hold the same rows and split
the heads, experts and vocabulary, or under ``fsdp_sp`` the sequence).
The **world** group is every rank, the default group: a leaf split over
both axes (``fsdp_sp``'s ``fsdp2``) is gathered over it, its block index
``d*M + m`` being the rank.  An axis that spans the world takes
the default group, which every collective of :class:`repro_torch.
distributed.DistContext` takes by default (so a data grid's are);
between 1 and the world, the grid makes one ``torch.distributed``
subgroup per row and per column, every rank calling ``new_group`` for
all of them in the same order (data columns, then model rows) before any
collective.  An axis of one is a group of one: its collectives are the
identity.

The ``pod`` axis is not run: a grid whose ``pod`` extent is above 1
raises, since running pod ranks as duplicates of data ranks would
compute the same numbers twice and call it data parallelism over pods.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from repro_torch.distributed.context import Group
from repro_torch.sharding.rules import AxisVal

AXIS_ORDER = ("pod", "data", "model")
NEXT_STEP = ("the multi-pod mesh's pod axis is not ported yet (ROADMAP.md "
             "Queue 1 item 1 step 5, its last part)")


class RankGrid:
    """One rank's place in a named grid of ``dist.world_size`` ranks.

    ``mesh`` is an axis-size dict whose product is the world size;
    ``dist`` the rank's :class:`repro_torch.distributed.DistContext`.
    :meth:`group` gives the rank's data or model group."""

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
        if self.mesh.get("pod", 1) > 1:
            raise NotImplementedError(
                f"grid {self.mesh}: a pod axis of {self.mesh['pod']}; "
                f"{NEXT_STEP}")
        self.dist = dist
        self.coords: Dict[str, int] = {}
        rest = dist.rank
        for axis in reversed(list(self.mesh)):
            rest, self.coords[axis] = divmod(rest, self.mesh[axis])
        self._groups = self._make_groups()

    def _make_groups(self) -> Dict[str, Group]:
        D, M = self.extent("data"), self.extent("model")
        world, rank = self.dist.world_size, self.dist.rank
        # the ranks of each data group (a model column) and each model
        # group (a data row), in the order every rank creates them
        members = {"data": [tuple(d * M + m for d in range(D))
                            for m in range(M)],
                   "model": [tuple(d * M + m for m in range(M))
                             for d in range(D)]}
        live = (self.dist.backend is not None
                and torch.distributed.is_initialized())
        groups = {"world": self.dist.world}
        for axis in ("data", "model"):
            for ranks in members[axis]:
                pg = None
                if live and 1 < len(ranks) < world:
                    # every rank calls new_group for every group
                    pg = torch.distributed.new_group(list(ranks))
                if rank in ranks:
                    groups[axis] = Group(ranks, ranks.index(rank), pg)
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
        """The rank's ``"data"``, ``"model"`` or ``"world"`` group."""
        return self._groups[axis]

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


def model_grid(dist, model: int) -> RankGrid:
    """The gang's ranks on ``{"data": world_size / model, "model":
    model}`` (a model extent of 1 is :func:`data_grid`)."""
    if model < 1 or dist.world_size % model:
        raise ValueError(f"a model extent of {model} does not divide the "
                         f"world of {dist.world_size}")
    if model == 1:
        return data_grid(dist)
    return RankGrid({"data": dist.world_size // model, "model": model},
                    dist)

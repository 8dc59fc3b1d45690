"""The gang's ranks as a named grid (port-only).

The reference lays its devices out as a JAX mesh with named axes
(``pod``, ``data``, ``model``) and lets XLA place each shard.  The port's
gang is N processes (:mod:`repro_torch.distributed`), one tensor of its
own each; :class:`RankGrid` names them: rank r sits at the row-major
coordinates of r over the mesh's axes in the reference's order.  On the
data axis, the one this slice runs, the axis spans the world, so its
``torch.distributed`` group is the default group, which every
collective of :class:`repro_torch.distributed.DistContext` takes; at
world 1 there is none and every collective is the identity.

This slice runs the **data** axis only.  There each rank holds its rows
of the batch and a 1/N shard of every sharded parameter
(:mod:`repro_torch.sharding.fsdp`), and the reference's ``fsdp_tp`` and
``fsdp_sp`` rules are pure ZeRO-3 (their ``tp`` entries drop out without
a ``model`` axis).  A grid whose ``model`` or ``pod`` extent is above 1
raises: running model ranks as duplicates of data ranks would compute
the same numbers twice and call it tensor parallelism.  What those axes
need is ROADMAP.md's Queue 1 item 1 step 5 (model-axis activations).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

from repro_torch.sharding.rules import AxisVal

AXIS_ORDER = ("pod", "data", "model")
NEXT_STEP = ("model-axis activations (fsdp_tp's tensor-parallel "
             "boundaries, fsdp_sp's sequence shards across ranks, the "
             "experts' all-to-all) are not ported yet: ROADMAP.md Queue 1 "
             "item 1 step 5")


class RankGrid:
    """One rank's place in a named grid of ``dist.world_size`` ranks.

    ``mesh`` is an axis-size dict whose product is the world size;
    ``dist`` the rank's :class:`repro_torch.distributed.DistContext`."""

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
        for axis in ("pod", "model"):
            if self.mesh.get(axis, 1) > 1:
                raise NotImplementedError(
                    f"grid {self.mesh}: a {axis} axis of "
                    f"{self.mesh[axis]}; {NEXT_STEP}")
        self.dist = dist
        self.coords: Dict[str, int] = {}
        rest = dist.rank
        for axis in reversed(list(self.mesh)):
            rest, self.coords[axis] = divmod(rest, self.mesh[axis])

    @property
    def world_size(self) -> int:
        return self.dist.world_size

    @property
    def rank(self) -> int:
        return self.dist.rank

    @property
    def device(self):
        return self.dist.device

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

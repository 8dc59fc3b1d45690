"""Activation-sharding context (the port's copy of
``repro.sharding.ctx``).

A :class:`ShardCtx` maps *logical* activation axes ("batch", "seq",
"embed", "heads", "experts", "vocab") to mesh axes.  The model code reads
it in two places, as the reference's does: the SSM mixer's sequence
shards (:func:`repro_torch.models.ssm._seq_shards`) and the MoE's
dispatch groups (:func:`repro_torch.models.moe._dispatch_groups`).  With
no ctx, or an axis with no mesh axis, every extent is 1: one shard
everywhere.

The reference's ``constrain`` has no counterpart.  It asks XLA to lay a
traced activation out over the mesh; the port's activations are explicit
tensors of one rank, so there is nothing to constrain.  A ctx whose
extents exceed 1 makes the model split a tensor it holds whole into the
reference's groups and segments (a single process standing in for the
mesh: the tests); a rank of a data grid holds only its own rows, which
are one group and one segment, as with no ctx, so it runs under none.

The ctx is a thread-local.  The backbone captures it and re-installs it
inside each checkpointed layer, so the recompute of the backward, which
autograd may run on another thread, takes the forward's branch.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional

from repro_torch.sharding.rules import AxisVal, axis_extent

_state = threading.local()


class ShardCtx:
    """Maps logical activation axes -> mesh axis names (or None) over a
    mesh given as an axis-size dict."""

    def __init__(self, mesh: Optional[Mapping[str, int]],
                 logical: Dict[str, AxisVal]):
        self.mesh = None if mesh is None else dict(mesh)
        self.logical = dict(logical)

    def extent(self, logical_name: str) -> int:
        """How many shards the logical axis has on the mesh (1 without
        a mesh or a mesh axis)."""
        if self.mesh is None:
            return 1
        return axis_extent(self.mesh, self.logical.get(logical_name))


def set_ctx(ctx: Optional[ShardCtx]) -> None:
    _state.ctx = ctx


def current_ctx() -> Optional[ShardCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardCtx]):
    prev = current_ctx()
    set_ctx(ctx)
    try:
        yield
    finally:
        set_ctx(prev)


def axis_extent_of(logical_name: str) -> int:
    """The current ctx's extent of a logical axis (1 with no ctx)."""
    ctx = current_ctx()
    return 1 if ctx is None else ctx.extent(logical_name)

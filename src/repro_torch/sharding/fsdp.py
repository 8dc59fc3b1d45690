"""FSDP storage on a rank grid (port-only): the counterpart of what XLA
does with the rules' ``in_shardings`` in the reference.

Each rank keeps only its block of every sharded leaf
(:meth:`FSDP.shard_tree`, along the spec's axes: on a data grid one dim,
split N ways).  The model gathers a leaf where it is used
(:meth:`FSDP.gather`): a ``torch.autograd.Function`` all-gathers the
shards in the forward and reduce-scatters the gradient in the backward,
so each rank's gradient comes back as its shard, already summed over
the ranks.  The backbone gathers a layer's leaves inside its checkpointed
forward, so the recompute of the backward gathers them again (the
analytic model's "fwd + bwd gathers") and no rank ever holds the whole
gathered tree or the whole gradient tree; the embedding, the head and
the final norm are gathered once where the loss uses them.

Replicated leaves (a spec of all ``None``, or one whose axes do not
divide: norms, ``A_log``, ``D``, ``dt_bias``) are held whole by every
rank; their gradients are all-reduced with the loss
(:func:`repro_torch.train.step.make_loss_and_grads`).

Elementwise optimizers (AdamW, SGDM) run on the shards unchanged; LAMB's
per-leaf norms sum their shards' squares over the grid
(:meth:`FSDP.reduce_sq`).  :meth:`FSDP.full_tree` gathers a whole tree
(for :mod:`repro_torch.convert` and checks).
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch

from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, shard, dim, dist):
        ctx.dim, ctx.dist = dim, dist
        return dist.all_gather(shard, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.dist.reduce_scatter(grad, ctx.dim), None, None


class FSDP:
    """The sharded storage of one parameter tree on ``grid`` (a
    :class:`repro_torch.sharding.grid.RankGrid`) under ``layout``.

    ``params_like`` is the FULL tree (any device, meta included): its
    shapes give the specs (:func:`rules.param_shardings` on the grid's
    mesh).  A leaf is sharded along the one dim whose spec entry has an
    extent above 1; a spec with two such dims needs the model axis and
    raises."""

    def __init__(self, grid, params_like, layout: str):
        self.grid = grid
        self.specs = rules.param_shardings(params_like, grid.mesh, layout)
        self.dims = tree_map(self._dim_of, self.specs)
        self.replicated: List[bool] = [d is None
                                       for d in tree_leaves(self.dims)]

    def _dim_of(self, spec) -> Optional[int]:
        dims = [i for i, e in enumerate(spec)
                if rules.axis_extent(self.grid.mesh, e) > 1]
        if len(dims) > 1:
            raise NotImplementedError(f"spec {spec} shards two dims")
        return dims[0] if dims else None

    # ------------------------------------------------------------ storage
    def _shard(self, t: torch.Tensor, spec, dim) -> torch.Tensor:
        if dim is None:
            return t
        index, count = self.grid.shard_of(spec[dim])
        size = t.shape[dim] // count
        # a copy: the full tensor is freed once every leaf is sharded
        return t.narrow(dim, index * size, size).clone()

    def shard_tree(self, tree):
        """Each rank's block of every leaf of the full ``tree`` (the
        params, or anything of their structure): copies of the sharded
        leaves' blocks, and the replicated leaves themselves."""
        return tree_map(self._shard, tree, self.specs, self.dims)

    def _gather(self, shard: torch.Tensor, dim) -> torch.Tensor:
        if dim is None:
            return shard
        return _Gather.apply(shard, dim, self.grid.dist)

    def gather(self, tree, dims):
        """``tree`` (shards) gathered whole, differentiably; ``dims`` is
        the matching subtree of :attr:`dims`."""
        return tree_map(self._gather, tree, dims)

    def layer_gather(self, i: int):
        """A callable that gathers ``params["layers"][i]`` (what the
        backbone hands each checkpointed layer)."""
        return functools.partial(self.gather, dims=self.dims["layers"][i])

    def gather_outer(self, params, skip=()):
        """Everything but the layer stack gathered whole (the embedding,
        the head, the final norm); the keys in ``skip`` (a leaf no
        output reads) stay shards."""
        return {k: (v if k == "layers" or k in skip
                    else self.gather(v, self.dims[k]))
                for k, v in params.items()}

    @torch.no_grad()
    def full_tree(self, tree):
        """The whole tree, gathered on every rank (no autograd)."""
        return tree_map(lambda t, d: t if d is None
                        else self.grid.dist.all_gather(t, d, "full_tree"
                                                       ).contiguous(),
                        tree, self.dims)

    # --------------------------------------------------------- reductions
    def reduce_sq(self, i: int, sq: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s (in ``tree_leaves`` order) squared-norm partial
        sums over the ranks that hold its shards (a replicated leaf's are
        already whole)."""
        if self.replicated[i]:
            return sq
        sq = sq.clone()
        self.grid.dist.allreduce_([sq], mechanism="norm_allreduce")
        return sq


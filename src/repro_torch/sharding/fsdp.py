"""FSDP storage on a rank grid (port-only): the counterpart of what XLA
does with the rules' ``in_shardings`` in the reference.

Each rank keeps only its block of every leaf (:meth:`FSDP.shard_tree`),
as :func:`repro_torch.sharding.rules.param_shardings` gives it: a spec
may split one dim over ``data`` and another over ``model`` (``fsdp_tp``'s
``(fsdp, tp)`` and ``(tp, fsdp)``), and the rank holds the block at its
coordinates on both.  The model gathers a leaf where it is used
(:meth:`FSDP.gather`) over the **data** group only: a
``torch.autograd.Function`` all-gathers the data shards in the forward
and reduce-scatters the gradient in the backward, so each rank's
gradient comes back as its block, already summed over its data group.
The model block stays local: the layers compute on it
(:mod:`repro_torch.sharding.tp`).  The backbone gathers a layer's leaves
inside its checkpointed forward, so the recompute of the backward
gathers them again (the analytic model's "fwd + bwd gathers") and no
rank ever holds the whole gathered tree or the whole gradient tree; the
embedding, the head and the final norm are gathered once where the loss
uses them.

A leaf is replicated over data (:attr:`FSDP.replicated`) when no dim of
its spec names ``data`` with an extent above 1 (norms, ``A_log``, ``D``,
``dt_bias``; ``conv_w``, ``conv_b`` and ``norm_scale``, which split over
``model`` only), and replicated over model (not in
:attr:`FSDP.model_sharded`) when none names ``model`` (the norms, the
router).  The gradients of the leaves replicated over data are
all-reduced over the data group with the loss
(:func:`repro_torch.train.step.make_loss_and_grads`); those replicated
over model come out equal on every model rank (every entry into a
tensor-parallel region passes an all-reduce in the backward), so nothing
reduces them over model.

Elementwise optimizers (AdamW, SGDM) run on the blocks unchanged; LAMB's
per-leaf norms sum their blocks' squares over every group that splits
the leaf (:meth:`FSDP.reduce_sq`).  :meth:`FSDP.full_tree` gathers a
whole tree over both axes (for :mod:`repro_torch.convert` and checks).
A ``model`` extent above 1 gives the storage a
:class:`repro_torch.sharding.tp.TP` (:attr:`FSDP.tp`), which the model's
layers compute with; a spec entry that names both axes above 1
(``fsdp_sp``'s ``fsdp2`` on a model axis) raises.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group`` forward, reduce-scatter
    backward."""

    @staticmethod
    def forward(ctx, shard, dim, dist, group):
        ctx.dim, ctx.dist, ctx.group = dim, dist, group
        return dist.all_gather(shard, dim, group=group)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.dist.reduce_scatter(grad, ctx.dim, group=ctx.group),
                None, None, None)


class FSDP:
    """The sharded storage of one parameter tree on ``grid`` (a
    :class:`repro_torch.sharding.grid.RankGrid`) under ``layout``.

    ``params_like`` is the FULL tree (any device, meta included): its
    shapes give the specs (:func:`rules.param_shardings` on the grid's
    mesh).  ``dims`` is the tree of each leaf's data-sharded dim (or
    None), ``model_dims`` of its model-sharded dim.  ``cfg`` (the arch
    config, needed where the grid has a model axis) gives the
    tensor-parallel plan."""

    def __init__(self, grid, params_like, layout: str, cfg=None):
        self.grid = grid
        self.specs = rules.param_shardings(params_like, grid.mesh, layout)
        both = tree_map(self._dims_of, self.specs)
        self.dims = tree_map(lambda s, b: b[0], self.specs, both)
        self.model_dims = tree_map(lambda s, b: b[1], self.specs, both)
        self.replicated: List[bool] = [d is None
                                       for d in tree_leaves(self.dims)]
        self.model_sharded: List[bool] = [
            d is not None for d in tree_leaves(self.model_dims)]
        self.tp = None
        if grid.extent("model") > 1:
            from repro_torch.sharding.tp import TP
            if cfg is None:
                raise ValueError("a grid with a model axis needs the arch "
                                 "config for its tensor-parallel plan")
            self.tp = TP(grid, cfg)

    def _dims_of(self, spec) -> Tuple[Optional[int], Optional[int]]:
        data = model = None
        for i, e in enumerate(spec):
            names = () if e is None else ((e,) if isinstance(e, str)
                                          else tuple(e))
            split = [n for n in names if self.grid.extent(n) > 1]
            if not split:
                continue
            if len(split) > 1:
                raise NotImplementedError(
                    f"spec {spec} splits one dim over {split}: fsdp_sp "
                    f"on a model axis needs its sequence shards (ROADMAP.md "
                    f"Queue 1 item 1 step 5)")
            if split[0] == "data" and data is None:
                data = i
            elif split[0] == "model" and model is None:
                model = i
            else:
                raise NotImplementedError(f"spec {spec} splits two dims "
                                          f"over {split[0]}")
        return data, model

    # ------------------------------------------------------------ storage
    def _narrow(self, t: torch.Tensor, spec, dim) -> torch.Tensor:
        if dim is None:
            return t
        index, count = self.grid.shard_of(spec[dim])
        size = t.shape[dim] // count
        return t.narrow(dim, index * size, size)

    def _shard(self, t: torch.Tensor, spec, dim, mdim) -> torch.Tensor:
        if dim is None and mdim is None:
            return t
        # a copy: the full tensor is freed once every leaf is sharded
        return self._narrow(self._narrow(t, spec, dim), spec, mdim).clone()

    def shard_tree(self, tree):
        """Each rank's block of every leaf of the full ``tree`` (the
        params, or anything of their structure): copies of the sharded
        leaves' blocks, and the leaves replicated over both axes
        themselves."""
        return tree_map(self._shard, tree, self.specs, self.dims,
                        self.model_dims)

    def _gather(self, shard: torch.Tensor, dim) -> torch.Tensor:
        if dim is None:
            return shard
        return _Gather.apply(shard, dim, self.grid.dist,
                             self.grid.group("data"))

    def gather(self, tree, dims):
        """``tree`` (blocks) gathered over the data group,
        differentiably; ``dims`` is the matching subtree of
        :attr:`dims`.  The model blocks stay as they are."""
        return tree_map(self._gather, tree, dims)

    def layer_gather(self, i: int):
        """A callable that gathers ``params["layers"][i]`` (what the
        backbone hands each checkpointed layer)."""
        return functools.partial(self.gather, dims=self.dims["layers"][i])

    def gather_outer(self, params, skip=()):
        """Everything but the layer stack gathered over data (the
        embedding, the head, the final norm); the keys in ``skip`` (a
        leaf no output reads) stay shards."""
        return {k: (v if k == "layers" or k in skip
                    else self.gather(v, self.dims[k]))
                for k, v in params.items()}

    @torch.no_grad()
    def full_tree(self, tree):
        """The whole tree, gathered over both axes on every rank (no
        autograd)."""
        dist = self.grid.dist

        def whole(t, d, md):
            if d is not None:
                t = dist.all_gather(t, d, "full_tree",
                                    group=self.grid.group("data"))
            if md is not None:
                t = dist.all_gather(t, md, "full_tree",
                                    group=self.grid.group("model"))
            return t if d is None and md is None else t.contiguous()

        return tree_map(whole, tree, self.dims, self.model_dims)

    # --------------------------------------------------------- reductions
    def reduce_sq(self, i: int, sq: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s (in ``tree_leaves`` order) squared-norm partial
        sums over the ranks that hold its blocks: its data group if it
        is split over data, its model group if over model (a leaf
        replicated over both is already whole)."""
        if self.replicated[i] and not self.model_sharded[i]:
            return sq
        sq = sq.clone()
        for axis, split in (("data", not self.replicated[i]),
                            ("model", self.model_sharded[i])):
            if split:
                self.grid.dist.allreduce_([sq], mechanism="norm_allreduce",
                                          group=self.grid.group(axis))
        return sq

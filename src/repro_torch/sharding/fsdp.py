"""FSDP storage on a rank grid (port-only): the counterpart of what XLA
does with the rules' ``in_shardings`` in the reference.

Each rank keeps only its block of every leaf (:meth:`FSDP.shard_tree`),
as :func:`repro_torch.sharding.rules.param_shardings` gives it: a spec
may split one dim over ``data`` and another over ``model`` (``fsdp_tp``'s
``(fsdp, tp)`` and ``(tp, fsdp)``), or one dim over both (``fsdp_sp``'s
``fsdp2``, ``("data", "model")``: D*M blocks, the rank holding block
``d*M + m``, JAX's order for a tuple axis and the rank's index in its
pod), and the rank holds the block at its coordinates.  The rules name
no ``pod``: every leaf is replicated across the pods.  The model
gathers a leaf where it is used (:meth:`FSDP.gather`): a
``torch.autograd.Function`` all-gathers the storage shards in the
forward and reduce-scatters the gradient in the backward, over the
**data** group for a dim split over data, over the **plane** (the
rank's pod; the world with one pod) for one split over both axes (over
the model group where the data extent is 1), so each rank's gradient
comes back as its block, already summed over that group.  A dim split
over ``model`` alone (a ``tp`` entry) stays local: the layers compute
on it (:mod:`repro_torch.sharding.tp`, and the MLP and vocabulary under
:mod:`repro_torch.sharding.sp`).  The backbone gathers a layer's leaves
inside its checkpointed forward, so the recompute of the backward
gathers them again (the analytic model's "fwd + bwd gathers") and no
rank ever holds the whole gathered tree or the whole gradient tree; the
embedding, the head and the final norm are gathered once where the loss
uses them.

A leaf is replicated over data (:attr:`FSDP.replicated`) when no dim of
its spec names ``data`` with an extent above 1 (norms, ``A_log``, ``D``,
``dt_bias``; under ``fsdp_tp`` ``conv_w``, ``conv_b`` and ``norm_scale``,
which split over ``model`` only), and replicated over model (not in
:attr:`FSDP.model_sharded`) when none names ``model`` (the norms, the
router).  What a gradient still needs after the gathers' reduce-scatters
is :attr:`FSDP.reduce`, the axes it is all-reduced over with the loss
(:func:`repro_torch.train.step.make_loss_and_grads`): ``data`` for a leaf
replicated over data.  Under ``fsdp_tp`` a leaf replicated over model
comes out equal on every model rank (every entry into a tensor-parallel
region passes an all-reduce in the backward), so nothing reduces it over
model.  Under ``fsdp_sp`` on a model axis it does not: the norms,
``A_log``, ``D`` and ``dt_bias`` (and a vocabulary the axis does not
split) see another block of the sequence on each model rank, so their
gradients are partial sums and are all-reduced over ``model`` too (over
the world for a leaf replicated over both).

Elementwise optimizers (AdamW, SGDM) run on the blocks unchanged; LAMB's
per-leaf norms sum their blocks' squares over every group that splits
the leaf (:meth:`FSDP.reduce_sq`).  :meth:`FSDP.full_tree` gathers a
whole tree over both axes (for :mod:`repro_torch.convert` and checks).
A ``model`` extent above 1 gives the storage a
:class:`repro_torch.sharding.tp.TP` (:attr:`FSDP.tp`) under ``fsdp_tp``
or a :class:`repro_torch.sharding.sp.SP` (:attr:`FSDP.sp`) under
``fsdp_sp``, which the model's layers compute with.
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
    mesh).  ``dims`` is the tree of each leaf's gathered dim (or None)
    and ``axes`` of the group it is gathered over (``"data"``,
    ``"model"`` or ``"plane"``), ``model_dims`` of its model block's dim
    (a ``tp`` entry).  ``cfg`` (the arch config, needed where the grid
    has a model axis) gives the tensor- or sequence-parallel plan."""

    def __init__(self, grid, params_like, layout: str, cfg=None):
        self.grid = grid
        self.specs = rules.param_shardings(params_like, grid.mesh, layout)
        each = tree_map(self._dims_of, self.specs)
        self.dims = tree_map(lambda s, e: e[0], self.specs, each)
        self.axes = tree_map(lambda s, e: e[1], self.specs, each)
        self.model_dims = tree_map(lambda s, e: e[2], self.specs, each)
        # the axes each leaf is split over
        split = [frozenset(() if a is None else
                           ("data", "model") if a == "plane" else (a,))
                 | (frozenset() if md is None else {"model"})
                 for a, md in zip(tree_leaves(self.axes),
                                  tree_leaves(self.model_dims))]
        self.replicated: List[bool] = ["data" not in s for s in split]
        self.model_sharded: List[bool] = ["model" in s for s in split]
        seq = layout == "fsdp_sp" and grid.extent("model") > 1
        self.reduce: List[frozenset] = [
            frozenset(a for a in ("data", "model")
                      if a not in s and (a == "data" or seq))
            for s in split]
        # the leaves whose gradient the pods sum by pod_gradsync: all but
        # those the loss's all-reduce over the batch group sums
        self.pod_sync: List[bool] = [
            grid.extent("pod") > 1 and r != {"data"} for r in self.reduce]
        self.tp = self.sp = None
        if grid.extent("model") > 1:
            if cfg is None:
                raise ValueError("a grid with a model axis needs the arch "
                                 "config for its tensor- or "
                                 "sequence-parallel plan")
            if seq:
                from repro_torch.sharding.sp import SP
                self.sp = SP(grid, cfg)
            else:
                from repro_torch.sharding.tp import TP
                self.tp = TP(grid, cfg)

    def _dims_of(self, spec) -> Tuple[Optional[int], Optional[str],
                                      Optional[int]]:
        """``(gathered dim, its group, model block dim)`` of a spec: an
        entry naming ``data`` (``fsdp``, or ``fsdp2``'s pair) is storage,
        gathered over the group of its axes above 1; a ``model`` entry
        alone is a model block."""
        gathered = axis = model = None
        for i, e in enumerate(spec):
            names = () if e is None else ((e,) if isinstance(e, str)
                                          else tuple(e))
            split = [n for n in names if self.grid.extent(n) > 1]
            if not split:
                continue
            if "data" in names:
                if gathered is not None:
                    raise NotImplementedError(f"spec {spec} gathers two "
                                              f"dims")
                gathered, axis = i, split[0] if len(split) == 1 else "plane"
            elif model is None:
                model = i
            else:
                raise NotImplementedError(f"spec {spec} splits two dims "
                                          f"over {split[0]}")
        return gathered, axis, model

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

    def _gather(self, shard: torch.Tensor, dim, axis) -> torch.Tensor:
        if dim is None:
            return shard
        return _Gather.apply(shard, dim, self.grid.dist,
                             self.grid.group(axis))

    def gather(self, tree, dims, axes):
        """``tree`` (blocks) gathered, differentiably; ``dims`` and
        ``axes`` are the matching subtrees of :attr:`dims` and
        :attr:`axes`.  The model blocks stay as they are."""
        return tree_map(self._gather, tree, dims, axes)

    def layer_gather(self, i: int):
        """A callable that gathers ``params["layers"][i]`` (what the
        backbone hands each checkpointed layer)."""
        return functools.partial(self.gather, dims=self.dims["layers"][i],
                                 axes=self.axes["layers"][i])

    def gather_outer(self, params, skip=()):
        """Everything but the layer stack gathered (the embedding, the
        head, the final norm); the keys in ``skip`` (a leaf no output
        reads) stay shards."""
        return {k: (v if k == "layers" or k in skip
                    else self.gather(v, self.dims[k], self.axes[k]))
                for k, v in params.items()}

    @torch.no_grad()
    def full_tree(self, tree):
        """The whole tree, gathered over both axes on every rank (no
        autograd)."""
        dist = self.grid.dist

        def whole(t, d, axis, md):
            if d is not None:
                t = dist.all_gather(t, d, "full_tree",
                                    group=self.grid.group(axis))
            if md is not None:
                t = dist.all_gather(t, md, "full_tree",
                                    group=self.grid.group("model"))
            return t if d is None and md is None else t.contiguous()

        return tree_map(whole, tree, self.dims, self.axes, self.model_dims)

    # --------------------------------------------------------- reductions
    def pod_gradsync_bytes(self, tree) -> float:
        """A rank's ``pod_gradsync`` bytes in one step from the shapes:
        an all-reduce over the P pods of each :attr:`pod_sync` leaf's
        block of ``tree`` (the rank's blocks, gradients' dtype), ``2 (P -
        1) / P`` of its bytes in the ring convention."""
        P = self.grid.extent("pod")
        held = sum(t.numel() * t.element_size()
                   for t, s in zip(tree_leaves(tree), self.pod_sync) if s)
        return 2.0 * held * (P - 1) / P

    def sync_pods(self, grads: list) -> None:
        """Sum the :attr:`pod_sync` gradient blocks over the rank's pod
        group, in place (nothing with one pod)."""
        part = [g for g, s in zip(grads, self.pod_sync) if s]
        if part:
            self.grid.dist.allreduce_(part, mechanism="pod_gradsync",
                                      group=self.grid.group("pod"))

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

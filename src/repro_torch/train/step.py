"""Training step: loss and gradients over the model + optimizer update,
with optional microbatch gradient accumulation (port of
``repro.train.step``).

* The reference jits the step and donates the ``TrainState``; here the
  step runs eagerly and the optimizer updates the parameters and its state
  **in place** under ``torch.no_grad()``, so a step allocates no second
  copy of the model.  The returned state holds the same tensors with the
  step count advanced.
* grad-norm and clipping share one global reduction: the squared-norm sum
  feeds both the ``grad_norm`` metric and the clip scale.
* a :class:`repro_torch.train.precision.Precision` policy selects the
  compute dtype; microbatch gradients accumulate in f32.
* with ``dist`` (a :class:`repro_torch.distributed.DistContext` of world
  N > 1) the step is one rank's share of a data-parallel step: the
  batch is the rank's rows, and the gradients and the loss are summed
  over the ranks before the norm, the clip and the update (see
  :func:`make_loss_and_grads`).  At world 1 it calls no collective and
  is the single-process step.
* with ``fsdp`` too (a :class:`repro_torch.sharding.fsdp.FSDP`) the
  state holds the rank's shards: the model gathers each leaf where it
  is used, the gradients come back as shards already reduce-scattered
  over the ranks, only the replicated leaves' gradients and the loss are
  all-reduced, and the norm adds the shards' squares over the ranks.
  The loss and the count are the rank's **batch** group's (its data
  group with one pod; with several, the ranks of every pod that split
  the batch): the ranks of a model group hold the same rows and the
  same loss.  A leaf's gradient is all-reduced over the axes of
  ``fsdp.reduce``: data for a leaf replicated over data (with the loss,
  over the batch group), and under ``fsdp_sp`` model too for one
  replicated over model (each model rank saw another block of the
  sequence), the plane for both; then every gradient not yet summed
  over the pods is all-reduced over the pod group (``pod_gradsync``,
  :meth:`repro_torch.sharding.fsdp.FSDP.sync_pods`).  The norm is taken
  within the pod, whose gradients are the pods' sum by then, each
  leaf's square counted once across both axes.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import (init_params, loss_count, loss_terms,
                                      train_loss, unused_leaves)
from repro_torch.optim import Optimizer, constant, get_optimizer
from repro_torch.train.precision import Precision, get_precision
from repro_torch.tree import tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def init_train_state(generator: Optional[torch.Generator], cfg: ArchConfig,
                     optimizer: Optional[Optimizer] = None,
                     state_dtype=None, *, device=None) -> TrainState:
    """Random parameters from ``generator`` (see
    :func:`repro_torch.models.model.init_params`; ``device`` defaults to
    ``cuda``) and the optimizer's zero state, at step 0."""
    optimizer = optimizer or get_optimizer(cfg.optimizer,
                                           state_dtype=state_dtype)
    params = init_params(cfg, generator, device=device)
    return TrainState(params, optimizer.init(params), 0)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    return [{k: x[i * (B // n):(i + 1) * (B // n)] for k, x in batch.items()}
            for i in range(n)]


def _global_sq_norm(grads, fsdp=None) -> torch.Tensor:
    """Single global reduction: sum of squared gradient entries (f32).
    Under ``fsdp`` each leaf's squares are summed over the ranks of the
    pod that split it (one all-reduce of a scalar for each kind of
    split: over data, over model, over both: the plane) and each
    replicated leaf counts once; the pods hold equal gradients."""
    sq = [g.float().square().sum() for g in tree_leaves(grads)]
    if fsdp is None:
        return sum(sq)
    grid = fsdp.grid
    split = list(zip(fsdp.replicated, fsdp.model_sharded))
    total = sum(q for q, s in zip(sq, split) if s == (True, False))
    # data only (a data grid's one reduction), model only, both
    for key, group in (((False, False), grid.group("data")),
                       ((True, True), grid.group("model")),
                       ((False, True), grid.group("plane"))):
        if any(s == key for s in split):
            part = sum((q for q, s in zip(sq, split) if s == key),
                       sq[0].new_zeros(()))
            grid.dist.allreduce_([part], mechanism="norm_allreduce",
                                 group=group)
            total = part + total
    return total


def _global_counts(dist, cfg: ArchConfig, mbs, group) -> list:
    """Each local microbatch's normalizer: the scored positions of the
    *global* microbatch it belongs to, summed over the data ``group``'s
    ranks (N of them; rank r its r-th).

    The single process cuts the global batch into ``n`` microbatches of
    consecutive rows.  Rank r holds rows ``[r B/N, (r+1) B/N)`` and cuts
    them into ``n`` too, so its microbatch j is a slice of global
    microbatch ``(r n + j) // N``, which is the local microbatches
    ``i N .. i N + N - 1`` of the rank-major order.  One small all-gather
    of every rank's ``n`` counts gives all of them."""
    n, world = len(mbs), group.size
    local = torch.stack([loss_count(cfg, mb) for mb in mbs])
    per_global = dist.allgather(local, group).reshape(n, world).sum(dim=1)
    return [per_global[(group.index * n + j) // world] for j in range(n)]


def make_loss_and_grads(cfg: ArchConfig, *, remat: bool = True,
                        microbatches: int = 1, loss_chunk: int = 512,
                        precision: Union[str, Precision, None] = "f32",
                        dist=None, fsdp=None):
    """Returns ``loss_and_grads(params, batch) -> (loss, grads)``: the
    step's loss and its gradient leaves in ``tree_leaves`` order,
    averaged over ``microbatches`` (accumulated in the policy's gradient
    dtype).

    ``dist``: the rank's context in a data-parallel job of world N > 1.
    The reference's loss over the global batch is ``tot / max(cnt, 1) +
    aux`` per global microbatch, ``cnt`` counted over every rank's rows
    (the masks of the audio and vlm families differ between ranks) and
    ``aux`` the mean of the ranks' MoE aux losses (its dispatch groups
    are the ranks' row shards).  So each rank differentiates ``tot_r /
    max(cnt, 1) + aux_r / N``, with ``cnt`` from one small all-gather
    before the backward, and one all-reduce sums the ranks' gradients
    and losses: the global gradient and loss.  At world 1 no collective
    runs.

    ``fsdp``: ``params`` are the rank's shards (see :mod:`repro_torch.
    sharding.fsdp`); the gather's backward reduce-scatters each sharded
    leaf's gradient, so the all-reduce takes only the replicated leaves'
    gradients and the loss.  N, the counts, the loss and those
    gradients are the grid's data group's: a model group's ranks hold
    the same rows and compute the same loss.
    """
    prec = get_precision(precision)
    grad_dtype = getattr(torch, prec.grad_dtype)
    compute_dtype = prec.compute_dtype if prec.casts_compute else None
    group = (None if dist is None else dist.world if fsdp is None
             else fsdp.grid.group("batch"))
    world = 1 if dist is None else group.size

    def objective(params, mb, count):
        if count is None:
            return train_loss(params, cfg, mb, remat=remat,
                              loss_chunk=loss_chunk,
                              compute_dtype=compute_dtype, fsdp=fsdp)
        tot, _, aux = loss_terms(params, cfg, mb, remat=remat,
                                 loss_chunk=loss_chunk,
                                 compute_dtype=compute_dtype, fsdp=fsdp)
        return tot / count.clamp_min(1.0) + aux / world

    def value_and_grad(params, mb, count):
        # detached aliases that require grad: the caller's tensors keep
        # their flags, and the gradients come back in tree_leaves order
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        unused = unused_leaves(params, cfg)
        with torch.enable_grad():
            loss = objective(tree_unflatten(params, leaves), mb, count)
            # leaves no output reads get a zero gradient, as in the
            # reference; every other leaf must reach the loss
            used = iter(torch.autograd.grad(
                loss, [p for p, u in zip(leaves, unused) if not u]))
        return loss.detach(), [torch.zeros_like(p) if u else next(used)
                               for p, u in zip(leaves, unused)]

    def loss_and_grads(params, batch):
        mbs = ([batch] if microbatches == 1
               else _split_microbatches(batch, microbatches))
        counts = ([None] * microbatches if world == 1
                  else _global_counts(dist, cfg, mbs, group))
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch, counts[0])
        else:
            losses, grads = [], None
            for mb, count in zip(mbs, counts):
                l, g = value_and_grad(params, mb, count)
                g = [gi.to(grad_dtype) for gi in g]
                losses.append(l)
                grads = g if grads is None else [
                    a + gi for a, gi in zip(grads, g)]
            loss = sum(losses) / microbatches
            grads = [g / microbatches for g in grads]
        if world > 1:
            # one sum over the ranks, the loss riding in the gradients'
            # last bucket (under fsdp: the replicated leaves' gradients)
            loss = loss.reshape(1)
            if fsdp is None:
                dist.allreduce_(grads + [loss])
            else:
                dist.allreduce_([g for g, r in zip(grads, fsdp.reduce)
                                 if r == {"data"}] + [loss],
                                mechanism="replicated_allreduce",
                                group=group)
            loss = loss[0]
        if fsdp is not None:
            # fsdp_sp on a model axis: the partial sums over the sequence
            # blocks of the leaves replicated over model
            for axis, key in (("model", {"model"}),
                              ("plane", {"data", "model"})):
                part = [g for g, r in zip(grads, fsdp.reduce) if r == key]
                if part:
                    fsdp.grid.dist.allreduce_(
                        part, mechanism="replicated_allreduce",
                        group=fsdp.grid.group(axis))
            fsdp.sync_pods(grads)
        return loss, grads

    return loss_and_grads


def make_train_step(cfg: ArchConfig, optimizer: Optional[Optimizer] = None,
                    lr_schedule: Optional[Callable] = None,
                    remat: bool = True, microbatches: int = 1,
                    loss_chunk: int = 512,
                    precision: Union[str, Precision, None] = "f32",
                    grad_clip: Optional[float] = None, dist=None,
                    fsdp=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    The step updates ``state.params`` and ``state.opt_state`` in place and
    returns a ``TrainState`` holding those same tensors at ``step + 1``.
    ``grad_clip`` clips the global gradient norm to the given value using
    the same reduction that produces the ``grad_norm`` metric.  With
    ``dist`` (see :func:`make_loss_and_grads`) the norm and the clip see
    the gradient summed over the ranks; with ``fsdp`` the state holds
    shards, and the norm and LAMB's trust ratios are taken over the
    whole leaves.
    """
    optimizer = optimizer or get_optimizer(cfg.optimizer)
    lr_schedule = lr_schedule or constant(1e-4)
    loss_and_grads = make_loss_and_grads(
        cfg, remat=remat, microbatches=microbatches, loss_chunk=loss_chunk,
        precision=precision, dist=dist, fsdp=fsdp)
    # only LAMB reads it (its trust ratio's whole-leaf norms)
    update_kw = {} if fsdp is None else {"reduce_sq": fsdp.reduce_sq}

    def train_step(state: TrainState, batch):
        params = state.params
        loss, grads = loss_and_grads(params, batch)

        # one global reduction feeds both the metric and the clip scale
        gnorm = torch.sqrt(_global_sq_norm(grads, fsdp))
        if grad_clip is not None and grad_clip > 0:
            scale = torch.clamp(grad_clip / gnorm.clamp_min(1e-12), max=1.0)
            grads = [(g.float() * scale).to(g.dtype) for g in grads]

        lr = lr_schedule(state.step)
        optimizer.update(tree_unflatten(params, grads), state.opt_state,
                         params, state.step, float(lr), **update_kw)
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        return state._replace(step=state.step + 1), metrics

    # the forward and backward alone, and the norm's reduction, for a
    # trace of them (the dry run)
    train_step.loss_and_grads = loss_and_grads
    train_step.sq_norm = functools.partial(_global_sq_norm, fsdp=fsdp)
    train_step.fsdp = fsdp
    return train_step


def make_eval_step(cfg: ArchConfig, loss_chunk: int = 512,
                   precision: Union[str, Precision, None] = "f32"):
    """Returns ``eval_step(params, batch) -> scalar loss`` (no remat, no
    gradients)."""
    prec = get_precision(precision)

    @torch.no_grad()
    def eval_step(params, batch):
        return train_loss(params, cfg, batch, remat=False,
                          loss_chunk=loss_chunk,
                          compute_dtype=(prec.compute_dtype
                                         if prec.casts_compute else None))

    return eval_step

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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import init_params, train_loss, unused_leaves
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


def _global_sq_norm(grads) -> torch.Tensor:
    """Single global reduction: sum of squared gradient entries (f32)."""
    return sum(g.float().square().sum() for g in tree_leaves(grads))


def make_train_step(cfg: ArchConfig, optimizer: Optional[Optimizer] = None,
                    lr_schedule: Optional[Callable] = None,
                    remat: bool = True, microbatches: int = 1,
                    loss_chunk: int = 512,
                    precision: Union[str, Precision, None] = "f32",
                    grad_clip: Optional[float] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    The step updates ``state.params`` and ``state.opt_state`` in place and
    returns a ``TrainState`` holding those same tensors at ``step + 1``.
    ``grad_clip`` clips the global gradient norm to the given value using
    the same reduction that produces the ``grad_norm`` metric.
    """
    optimizer = optimizer or get_optimizer(cfg.optimizer)
    lr_schedule = lr_schedule or constant(1e-4)
    prec = get_precision(precision)
    grad_dtype = getattr(torch, prec.grad_dtype)
    compute_dtype = prec.compute_dtype if prec.casts_compute else None

    def value_and_grad(params, mb):
        # detached aliases that require grad: the caller's tensors keep
        # their flags, and the gradients come back in tree_leaves order
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        unused = unused_leaves(params, cfg)
        with torch.enable_grad():
            loss = train_loss(tree_unflatten(params, leaves), cfg, mb,
                              remat=remat, loss_chunk=loss_chunk,
                              compute_dtype=compute_dtype)
            # leaves no output reads get a zero gradient, as in the
            # reference; every other leaf must reach the loss
            used = iter(torch.autograd.grad(
                loss, [p for p, u in zip(leaves, unused) if not u]))
        return loss.detach(), [torch.zeros_like(p) if u else next(used)
                               for p, u in zip(leaves, unused)]

    def train_step(state: TrainState, batch):
        params = state.params
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            losses, grads = [], None
            for mb in _split_microbatches(batch, microbatches):
                l, g = value_and_grad(params, mb)
                g = [gi.to(grad_dtype) for gi in g]
                losses.append(l)
                grads = g if grads is None else [
                    a + gi for a, gi in zip(grads, g)]
            loss = sum(losses) / microbatches
            grads = [g / microbatches for g in grads]

        # one global reduction feeds both the metric and the clip scale
        gnorm = torch.sqrt(_global_sq_norm(grads))
        if grad_clip is not None and grad_clip > 0:
            scale = torch.clamp(grad_clip / gnorm.clamp_min(1e-12), max=1.0)
            grads = [(g.float() * scale).to(g.dtype) for g in grads]

        lr = lr_schedule(state.step)
        optimizer.update(tree_unflatten(params, grads), state.opt_state,
                         params, state.step, float(lr))
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        return state._replace(step=state.step + 1), metrics

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

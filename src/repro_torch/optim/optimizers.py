"""Optimizers of the reference (``repro.optim.optimizers``): SGD
(+momentum), Adam / AdamW and LAMB, as functional ``init``/``update`` pairs
over the port's parameter trees.  ``torch.optim`` is not used: the
reference adds ``wd * p`` to the Adam update before the learning rate,
where ``torch.optim.AdamW`` first scales ``p *= 1 - lr*wd`` (the same value,
rounded differently), and its bias correction and casts differ too.

The reference returns new trees and donates the old ones; here ``update``
writes the new parameters and optimizer state **in place** under
``torch.no_grad()`` and returns the same trees.  Arithmetic is f32 and the
results are cast back to each parameter's and state's dtype, so the
optimizer state may be held in bf16 (``state_dtype``).

Under a parameter-sharded layout the trees hold a rank's shards.  SGD,
SGDM and Adam(W) are elementwise and run on them unchanged; LAMB's trust
ratio needs each leaf's whole norms, so ``update`` takes ``reduce_sq``
(:meth:`repro_torch.sharding.fsdp.FSDP.reduce_sq`), which sums a leaf's
squared-norm partials over the ranks holding its blocks: over its data
group, its model group, or both for a leaf split over both axes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable     # params -> state
    # (grads, state, params, step, lr, reduce_sq=None) -> (params, state)
    update: Callable
    name: str = ""


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _tree_zeros_like(params, dtype=None):
    return tree_map(
        lambda p: torch.zeros_like(p, dtype=_dtype(dtype) or p.dtype), params)


def sgd(weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step, lr, reduce_sq=None):
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            g = g.float() + weight_decay * p.float()
            p.copy_(p.float() - lr * g)
        return params, state

    return Optimizer(init, update, "sgd")


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0,
         state_dtype=None) -> Optimizer:
    def init(params):
        return {"m": _tree_zeros_like(params, state_dtype)}

    @torch.no_grad()
    def update(grads, state, params, step, lr, reduce_sq=None):
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["m"])):
            g = g.float() + weight_decay * p.float()
            m_new = momentum * m.float() + g
            p.copy_(p.float() - lr * m_new)
            m.copy_(m_new)
        return params, state

    return Optimizer(init, update, "sgdm")


def _adam_core(grads, state, params, step, lr, b1, b2, eps, wd,
               trust_ratio: bool, reduce_sq=None):
    ps = tree_leaves(params)
    # bias correction at t = step + 1, in f32 as the reference's
    f32 = dict(dtype=torch.float32, device=ps[0].device)
    t = torch.tensor(float(step) + 1.0, **f32)
    c1 = 1 - torch.tensor(b1, **f32) ** t
    c2 = 1 - torch.tensor(b2, **f32) ** t
    leaves = zip(ps, tree_leaves(grads), tree_leaves(state["m"]),
                 tree_leaves(state["v"]))
    for i, (p, g, m, v) in enumerate(leaves):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf.square()
        mhat = m_new / c1
        vhat = v_new / c2
        u = mhat / (vhat.sqrt() + eps)
        if wd:
            # added to the update before lr: not torch's decoupled decay
            u = u + wd * p.float()
        if trust_ratio and reduce_sq is not None:
            # the whole leaf's norms from its shards' squares
            pn, un = reduce_sq(i, torch.stack([p.float().square().sum(),
                                               u.square().sum()])).sqrt()
        elif trust_ratio:
            pn = torch.linalg.vector_norm(p.float())
            un = torch.linalg.vector_norm(u)
        if trust_ratio:
            ratio = torch.where((pn > 0) & (un > 0),
                                pn / un.clamp_min(1e-9), 1.0)
            u = ratio * u
        p.copy_(p.float() - lr * u)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, state


def _adam_family(name, b1, b2, eps, wd, trust_ratio, state_dtype):
    def init(params):
        return {"m": _tree_zeros_like(params, state_dtype),
                "v": _tree_zeros_like(params, state_dtype)}

    @torch.no_grad()
    def update(grads, state, params, step, lr, reduce_sq=None):
        return _adam_core(grads, state, params, step, lr, b1, b2, eps, wd,
                          trust_ratio, reduce_sq)

    return Optimizer(init, update, name)


def adam(b1=0.9, b2=0.999, eps=1e-8, state_dtype=None) -> Optimizer:
    return _adam_family("adam", b1, b2, eps, 0.0, False, state_dtype)


def adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          state_dtype=None) -> Optimizer:
    return _adam_family("adamw", b1, b2, eps, weight_decay, False,
                        state_dtype)


def lamb(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01,
         state_dtype=None) -> Optimizer:
    """LAMB (You et al.): Adam with a per-leaf trust ratio."""
    return _adam_family("lamb", b1, b2, eps, weight_decay, True, state_dtype)


def get_optimizer(name: str, *, state_dtype=None, **kw) -> Optimizer:
    name = name.lower()
    if name == "sgd":
        return sgd(**kw)
    if name == "sgdm":
        return sgdm(state_dtype=state_dtype, **kw)
    if name == "adam":
        return adam(state_dtype=state_dtype, **kw)
    if name == "adamw":
        return adamw(state_dtype=state_dtype, **kw)
    if name == "lamb":
        return lamb(state_dtype=state_dtype, **kw)
    raise ValueError(f"unknown optimizer {name!r}")

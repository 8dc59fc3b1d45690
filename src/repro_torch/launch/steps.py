"""Shared step builders (the port's copy of ``repro.launch.steps``): given
(arch config, input shape, layout, rank grid) produce the step function
and its argument tensors, on the device the caller names: ``meta`` for
the dry run (shapes only, nothing allocated) or the card for the probe.

The reference returns a jitted step whose ``in_shardings`` come from the
rules over a device mesh, and lowers it under :func:`shard_ctx_for`'s
ctx.  The port returns a plain callable over one rank's tensors:

* no grid, or a grid of one rank: today's world-1 step, whatever the
  layout (``dp`` bit for bit);
* ``dp`` on a grid of N: the data-parallel gang's step (replicated
  parameters, the gradients all-reduced);
* ``fsdp_tp`` / ``fsdp_sp`` on a data grid of N: the rank keeps its
  shards of the parameters and moments
  (:class:`repro_torch.sharding.fsdp.FSDP`, the rules'
  :func:`state_shardings`), and the step gathers each layer where it
  runs;
* ``fsdp_tp`` on a ``{data: D, model: M}`` grid: the rank keeps its
  ``(data, model)`` block of each leaf and computes on its heads,
  experts, MLP columns and vocabulary rows (:mod:`repro_torch.sharding.
  tp`); a model group's ranks hold the same rows;
* ``fsdp_sp`` on a ``{data: D, model: M}`` grid: the rank keeps its
  blocks (the attention and SSM projections split over both axes) and
  computes on its model coordinate's block of the sequence
  (:mod:`repro_torch.sharding.sp`), for training and prefill (an MoE
  slot's experts exchanged by all-to-all); a decode step runs on its
  blocks of the decode state (cache slots, SSM heads and conv channels:
  the rules' ``decode_state_shardings``), with a softmax distributed
  over the cache.

* any of them on a grid with a ``pod`` axis: the pods are replicas (the
  reference's pod axis is pure data parallelism); each rank keeps the
  blocks its ``(data, model)`` coordinates give it, the batch splits
  over ``(pod, data)``, and the step sums every gradient over the pods
  once (:mod:`repro_torch.sharding.fsdp`, ``pod_gradsync``).

Every rank draws the full parameters and the global batch from the seed
and keeps its blocks and its rows: :func:`_rows` splits the batch over
the grid's batch group as the reference's ``batch_sharding`` does, over
``(pod, data)`` or over the axes of it whose extent divides the batch,
the rest of the ranks holding the same rows (``long_500k``'s one row is
replicated); under ``fsdp_sp`` the model axis splits the sequence.  A
decode step's cache holds the rank's rows (``decode_state_shardings``
puts the batch over the same axes at every ``INPUT_SHAPES`` cell).  A
train step takes rows that split over the whole batch group: replicated
rows would be counted twice in the loss.  So a gang computes the
world-1 step's numbers.  A rank's rows are its MoE dispatch group and,
but under ``fsdp_sp``'s model axis, its sequence one segment, as with
no :class:`repro_torch.sharding.ShardCtx`, so a step runs under none
(:func:`shard_ctx_for` is the reference's ctx of the whole mesh).  On a
``model`` extent above 1 ``dp`` raises (it would run duplicated ranks),
and so does ``fsdp_sp`` at a sequence the axis does not split into
equal blocks (:func:`repro_torch.sharding.sp.check_config`).  A ``meta``
device with a grid over :func:`repro_torch.distributed.context.
meta_context` builds one rank of a mesh no host holds: the dry run's
rank trace.
``lower_step`` has no counterpart: nothing is lowered.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.inputs import (decode_specs, input_specs, make_batch,
                                     make_decode_batch)
from repro_torch.distributed.data import shard_rows
from repro_torch.models.model import (decode_step, forward,
                                      init_decode_state, init_params,
                                      param_specs, prefill, require_decoder)
from repro_torch.optim import get_optimizer
from repro_torch.sharding import ShardCtx, rules
from repro_torch.sharding.fsdp import FSDP
from repro_torch.sharding.sp import check_config
from repro_torch.train.step import TrainState, make_train_step

BIG_PARAM_THRESHOLD = 20e9   # above this, optimizer moments go bf16


def pick_optimizer(cfg: ArchConfig):
    state_dtype = ("bfloat16" if cfg.param_count() > BIG_PARAM_THRESHOLD
                   else None)
    return get_optimizer(cfg.optimizer, state_dtype=state_dtype)


def effective_config(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """Shape-specific config tweaks (the reference's): long_500k forces
    the sliding-window variant for attention archs."""
    if (shape_name == "long_500k" and cfg.has_attention
            and cfg.family != "hybrid"):
        if cfg.sliding_window is None:
            cfg = dataclasses.replace(cfg, sliding_window=8192)
    return cfg


def shard_ctx_for(mesh, layout: str) -> ShardCtx:
    """The reference's ctx for a mesh (an axis-size dict) and layout."""
    return ShardCtx(mesh, rules.logical_axes(mesh, layout))


def state_shardings(cfg: ArchConfig, mesh, layout: str,
                    optimizer=None) -> TrainState:
    """The train state's specs on ``mesh`` (the reference's
    ``in_shardings`` of the state): the parameters' by the rules, the
    optimizer moments' the same, the step replicated."""
    optimizer = optimizer or pick_optimizer(cfg)
    params = param_specs(cfg)
    return TrainState(rules.param_shardings(params, mesh, layout),
                      rules.param_shardings(optimizer.init(params), mesh,
                                            layout), ())


def _sharding(cfg: ArchConfig, layout: str, grid, params, seq: int,
              kind: str = "train"):
    """``(dist, fsdp)`` of a step on ``grid``: none at world 1; the
    rank's context, and FSDP storage unless the layout is ``dp``."""
    if grid is None or grid.world_size == 1:
        return None, None
    if grid.extent("model") > 1:
        if layout == "fsdp_sp" and kind != "decode":
            check_config(cfg, seq, grid.extent("model"))
        if layout == "dp":
            raise ValueError(f"grid {grid.mesh}: dp replicates every "
                             f"parameter, so a model axis would run "
                             f"duplicated ranks; use fsdp_tp")
    if layout == "dp":
        return grid.dist, None
    return grid.dist, FSDP(grid, params, layout, cfg)


def _rows(inputs, grid, kind: str = "prefill"):
    """The rank's rows of the global batch: its block over the batch
    group (:meth:`RankGrid.batch_block`); a train step's rows must split
    over the whole group."""
    if grid is None or grid.world_size == 1:
        return inputs
    rows = next(iter(inputs.values())).shape[0]
    index, count = grid.batch_block(rows)
    if kind == "train" and count != grid.group("batch").size:
        raise NotImplementedError(
            f"grid {grid.mesh}: a train batch of {rows} does not split "
            f"over the {grid.group('batch').size} ranks of (pod, data); "
            f"replicated rows would count twice in the loss")
    return inputs if count == 1 else shard_rows(inputs, index, count)


def _is_meta(device) -> bool:
    return torch.device(device).type == "meta"


def _params(cfg: ArchConfig, device, seed: int):
    if _is_meta(device):
        return param_specs(cfg)
    return init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                       device=device)


def _inputs(cfg: ArchConfig, batch: int, seq: int, device, seed: int):
    if _is_meta(device):
        return input_specs(cfg, batch, seq)
    return make_batch(cfg, batch, seq, seed, device=device)


# --------------------------------------------------------------------------
def build_train(cfg: ArchConfig, batch: int, seq: int, *, device,
                layout: str = "dp", grid=None, microbatches: int = 1,
                remat: bool = True, seed: int = 0) -> Tuple[Callable, tuple]:
    """``train_step(state, batch) -> (state, metrics)`` (the optimizer
    updates ``state`` in place) and ``(state, batch)``: on a grid of N,
    the rank's state (its shards under ``fsdp_*``) and its rows of the
    global ``batch``."""
    optimizer = pick_optimizer(cfg)
    params = _params(cfg, device, seed)
    dist, fsdp = _sharding(cfg, layout, grid, params, seq)
    step_fn = make_train_step(cfg, optimizer, remat=remat,
                              microbatches=microbatches, dist=dist,
                              fsdp=fsdp)
    if fsdp is not None:
        params = fsdp.shard_tree(params)
    state = TrainState(params, optimizer.init(params), 0)
    return step_fn, (state, _rows(_inputs(cfg, batch, seq, device, seed),
                                  grid, "train"))


def build_prefill(cfg: ArchConfig, batch: int, seq: int, *, device,
                  layout: str = "dp", grid=None,
                  seed: int = 0) -> Tuple[Callable, tuple]:
    """``fn(params, batch) -> (last logits, decode state)`` (an
    encoder-only config: the last position's logits) and ``(params,
    batch)``: on a grid of N the rank's params (shards under
    ``fsdp_*``) and rows."""
    params = _params(cfg, device, seed)
    _, fsdp = _sharding(cfg, layout, grid, params, seq, "prefill")
    if cfg.is_encoder_only:
        @torch.no_grad()
        def fn(params, batch_in):
            return forward(params, cfg, batch_in, remat=False,
                           fsdp=fsdp)[:, -1, :]
    else:
        def fn(params, batch_in):
            return prefill(params, cfg, batch_in, cache_len=seq, fsdp=fsdp)
    if fsdp is not None:
        params = fsdp.shard_tree(params)
    return fn, (params, _rows(_inputs(cfg, batch, seq, device, seed), grid))


def build_decode(cfg: ArchConfig, batch: int, seq: int, *, device,
                 layout: str = "dp", grid=None,
                 seed: int = 0) -> Tuple[Callable, tuple]:
    """serve_step: ONE new token against a cache of ``seq`` positions.
    ``fn(params, state, tokens, position) -> (logits, state)`` and its
    arguments; the token sits at position ``seq - 1``.  On a grid of N
    the rank's params (shards under ``fsdp_*``), its rows of the tokens
    and positions, and a decode state of its rows (the rules' batch
    axis) and, on a model axis, of its blocks (``fsdp_tp`` and
    ``fsdp_sp`` alike: the cache's slots, the SSM heads and conv
    channels)."""
    require_decoder(cfg)
    params = _params(cfg, device, seed)
    _, fsdp = _sharding(cfg, layout, grid, params, seq, "decode")

    def fn(params, state, tokens, position):
        return decode_step(params, cfg, state, tokens, position, fsdp=fsdp,
                           cache_len=seq)

    if fsdp is not None:
        params = fsdp.shard_tree(params)
    d = _rows(decode_specs(cfg, batch) if _is_meta(device)
              else make_decode_batch(cfg, batch, seq - 1, seed,
                                     device=device), grid)
    state = init_decode_state(cfg, d["tokens"].shape[0], seq, device=device,
                              grid=grid, layout=layout)
    return fn, (params, state, d["tokens"], d["position"])


def build(kind: str, cfg: ArchConfig, batch: int, seq: int, *, device,
          **kw) -> Tuple[Callable, tuple]:
    if kind == "train":
        return build_train(cfg, batch, seq, device=device, **kw)
    if kind == "prefill":
        return build_prefill(cfg, batch, seq, device=device, **kw)
    if kind == "decode":
        return build_decode(cfg, batch, seq, device=device, **kw)
    raise ValueError(kind)

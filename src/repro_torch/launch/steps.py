"""Shared step builders (the port's copy of ``repro.launch.steps``): given
(arch config, input shape) produce the step function and its argument
tensors, on the device the caller names: ``meta`` for the dry run (shapes
only, nothing allocated) or the card for the probe.

The reference returns a jitted step with in/out shardings over a device
mesh and lowers it (``lower_step``, ``shard_ctx_for``).  The port has no
parameter-sharded layout yet: under ``dp`` a step is world 1, and a
builder returns a plain callable.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.inputs import (decode_specs, input_specs, make_batch,
                                     make_decode_batch)
from repro_torch.models.model import (decode_step, forward,
                                      init_decode_state, init_params,
                                      param_specs, prefill, require_decoder)
from repro_torch.optim import get_optimizer
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
                microbatches: int = 1, remat: bool = True,
                seed: int = 0) -> Tuple[Callable, tuple]:
    """``train_step(state, batch) -> (state, metrics)`` (the optimizer
    updates ``state`` in place) and ``(state, batch)``."""
    optimizer = pick_optimizer(cfg)
    step_fn = make_train_step(cfg, optimizer, remat=remat,
                              microbatches=microbatches)
    params = _params(cfg, device, seed)
    state = TrainState(params, optimizer.init(params), 0)
    return step_fn, (state, _inputs(cfg, batch, seq, device, seed))


def build_prefill(cfg: ArchConfig, batch: int, seq: int, *, device,
                  seed: int = 0) -> Tuple[Callable, tuple]:
    """``fn(params, batch) -> (last logits, decode state)`` (an
    encoder-only config: the last position's logits) and ``(params,
    batch)``."""
    if cfg.is_encoder_only:
        @torch.no_grad()
        def fn(params, batch_in):
            return forward(params, cfg, batch_in, remat=False)[:, -1, :]
    else:
        def fn(params, batch_in):
            return prefill(params, cfg, batch_in, cache_len=seq)
    return fn, (_params(cfg, device, seed),
                _inputs(cfg, batch, seq, device, seed))


def build_decode(cfg: ArchConfig, batch: int, seq: int, *, device,
                 seed: int = 0) -> Tuple[Callable, tuple]:
    """serve_step: ONE new token against a cache of ``seq`` positions.
    ``fn(params, state, tokens, position) -> (logits, state)`` and its
    arguments; the token sits at position ``seq - 1``."""
    require_decoder(cfg)

    def fn(params, state, tokens, position):
        return decode_step(params, cfg, state, tokens, position)

    state = init_decode_state(cfg, batch, seq, device=device)
    d = (decode_specs(cfg, batch) if _is_meta(device)
         else make_decode_batch(cfg, batch, seq - 1, seed, device=device))
    return fn, (_params(cfg, device, seed), state, d["tokens"],
                d["position"])


def build(kind: str, cfg: ArchConfig, batch: int, seq: int, *, device,
          **kw) -> Tuple[Callable, tuple]:
    if kind == "train":
        return build_train(cfg, batch, seq, device=device, **kw)
    if kind == "prefill":
        return build_prefill(cfg, batch, seq, device=device, **kw)
    if kind == "decode":
        return build_decode(cfg, batch, seq, device=device, **kw)
    raise ValueError(kind)

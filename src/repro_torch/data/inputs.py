"""Model inputs (the port's copy of ``repro.data.inputs``).

``input_specs`` returns meta tensors (shape and dtype, no allocation), the
counterpart of the reference's ``jax.ShapeDtypeStruct`` stand-ins;
``make_batch`` returns concrete random tensors on a device.  For the
``vlm`` and ``audio`` families the modality frontend is a stub, as in the
reference: the specs provide precomputed patch/frame embeddings of the
right shape.

The random draws are the reference's, in the same order from one
``np.random.default_rng(seed)``, so for the same seed the port's batches
equal the reference's bit for bit (an f32 draw goes to bf16 by rounding to
nearest even, as in jnp).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _act_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def vlm_patches(cfg: ArchConfig, seq: int) -> int:
    """Patch positions of a vlm sequence of ``seq``: the frontend's
    tokens, at most a quarter of the sequence (at least one)."""
    return min(cfg.frontend_tokens, max(seq // 4, 1))


def input_specs(cfg: ArchConfig, batch: int,
                seq: int) -> Dict[str, torch.Tensor]:
    """Training/prefill inputs of one global batch, as meta tensors."""
    if cfg.family == "audio":
        return {
            "features": _spec((batch, seq, cfg.d_model), _act_dtype(cfg)),
            "labels": _spec((batch, seq), torch.int32),
            "mask": _spec((batch, seq), torch.bool),
        }
    if cfg.family == "vlm":
        P = vlm_patches(cfg, seq)
        return {
            "patches": _spec((batch, P, cfg.d_model), _act_dtype(cfg)),
            "tokens": _spec((batch, seq - P), torch.int32),
        }
    return {"tokens": _spec((batch, seq), torch.int32)}


def decode_specs(cfg: ArchConfig, batch: int) -> Dict[str, torch.Tensor]:
    """serve_step inputs: ONE new token + absolute positions."""
    return {
        "tokens": _spec((batch, 1), torch.int32),
        "position": _spec((batch,), torch.int32),
    }


def make_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0, *,
               device) -> Dict[str, torch.Tensor]:
    """Concrete random batch matching ``input_specs``, on ``device``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in input_specs(cfg, batch, seq).items():
        shape = tuple(s.shape)
        if s.dtype == torch.int32:
            hi = cfg.vocab if name in ("tokens", "labels") else 2
            t = torch.from_numpy(
                rng.integers(0, hi, size=shape, dtype=np.int64)).to(
                    torch.int32)
        elif s.dtype == torch.bool:
            t = torch.from_numpy(rng.random(shape) < 0.3)
        else:
            t = torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(s.dtype)
        out[name] = t.to(device)
    return out


class SeekableSyntheticBatches:
    """Step-indexed ``make_batch`` stream with a trivial cursor: batch i
    is a pure function of ``(cfg, seed + i)``, so seeking is O(1) and a
    resumed run sees the identical sequence (the multimodal counterpart
    of :class:`repro_torch.data.tokens.SeekableTokenBatches`)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                 *, device):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.device = device
        self.step = 0

    def next_batch(self) -> Dict[str, torch.Tensor]:
        b = make_batch(self.cfg, self.batch, self.seq,
                       seed=self.seed + self.step, device=self.device)
        self.step += 1
        return b

    def cursor(self) -> dict:
        return {"step": self.step}

    def seek(self, cursor: dict) -> None:
        self.step = int(cursor["step"])

    def __iter__(self):
        while True:
            yield self.next_batch()


def make_decode_batch(cfg: ArchConfig, batch: int, position: int,
                      seed: int = 0, *, device) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    return {
        "tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, size=(batch, 1))).to(
                device=device, dtype=torch.int32),
        "position": torch.full((batch,), position, dtype=torch.int32,
                               device=device),
    }

"""Learning-rate schedules of the reference (``repro.optim.schedules``).
Each maps a step (int or integer tensor) to a 0-d f32 tensor, computed in
f32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def step_decay(lr: float, decay_factor: float = 0.5, every: int = 50):
    """Paper: 'the learning rate decreases by a factor of 0.5 every 50
    epochs'."""
    def fn(step):
        k = torch.floor(_f32(step) / every)
        return torch.tensor(lr, dtype=torch.float32) * (decay_factor ** k)
    return fn


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, total_steps: int, warmup_steps: int = 100,
                  final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn

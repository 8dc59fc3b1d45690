"""Dynamic batch sizing from accelerator memory (the port's copy of
``repro.core.autobatch``).

Paper, Sect. III-A: "the batch size is dynamically set based on available
GPU memory, as the GPUs on Nautilus range from as little as the NVIDIA
GTX 1080 (11 GB) to as high as the NVIDIA A100 (80GB)".

The same mechanism picks the per-replica batch given the model's analytic
footprint: params + optimizer state + gradients (sharded by the layout)
are the fixed cost, activations-per-sample (with the remat policy) the
variable cost.  The budget carries no default size: it is either given
(``MemoryBudget(device_gb=...)``) or read from the card
(:meth:`MemoryBudget.of_device`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    device_gb: float
    reserve_frac: float = 0.15       # runtime/fragmentation reserve

    @classmethod
    def of_device(cls, device="cuda") -> "MemoryBudget":
        """The budget of a CUDA card: its total memory as
        ``torch.cuda.mem_get_info`` reports it.  Raises without a card."""
        import torch
        _, total = torch.cuda.mem_get_info(torch.device(device))
        return cls(device_gb=total / 1e9)


OPT_STATE_MULT = {"sgd": 0, "sgdm": 1, "adam": 2, "adamw": 2, "lamb": 2}


def fixed_bytes_per_device(cfg: ArchConfig, n_shards: int = 1,
                           opt_state_bytes: int = None) -> float:
    """params + grads + optimizer moments, sharded over `n_shards`."""
    pb = 2 if "16" in cfg.param_dtype else 4
    sb = opt_state_bytes if opt_state_bytes is not None else pb
    P = cfg.param_count()
    per = P * (pb            # params
               + pb          # grads
               + sb * OPT_STATE_MULT.get(cfg.optimizer, 2))
    return per / n_shards


def activation_bytes_per_sample(cfg: ArchConfig, seq: int,
                                act_shards: int = 1,
                                remat: bool = True) -> float:
    """Layer-boundary activations per sample with per-layer remat: one
    (seq, d) tensor per layer saved, plus ~2 working layers."""
    pb = 2 if "16" in cfg.param_dtype else 4
    boundaries = cfg.n_layers if remat else 6 * cfg.n_layers
    working = 8  # live intermediates inside the current (re)computed layer
    per = (boundaries + working) * seq * cfg.d_model * pb
    return per / act_shards


def autobatch(cfg: ArchConfig, seq: int, *, budget: MemoryBudget = None,
              n_shards: int = 1, act_shards: int = 1,
              remat: bool = True, max_batch: int = 4096,
              min_batch: int = 1) -> int:
    """Largest power-of-two per-replica batch that fits the device budget
    (``budget``, else the card's own: :meth:`MemoryBudget.of_device`).
    Returns 0 if even ``min_batch`` does not fit (the paper-faithful DP
    regime hits this for the 398B/400B architectures — the motivation for
    its multi-pod future work)."""
    budget = budget or MemoryBudget.of_device()
    avail = budget.device_gb * 1e9 * (1 - budget.reserve_frac)
    fixed = fixed_bytes_per_device(cfg, n_shards)
    per_sample = activation_bytes_per_sample(cfg, seq, act_shards, remat)
    room = avail - fixed
    if room < per_sample * min_batch:
        return 0
    b = int(room // per_sample)
    b = min(b, max_batch)
    # round down to a power of two (batch-size ladders in the paper's grids)
    p = 1
    while p * 2 <= b:
        p *= 2
    return p

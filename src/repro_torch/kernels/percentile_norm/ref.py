"""Plain PyTorch versions of the percentile stretch: the counterpart of the
reference's oracle ``repro.kernels.percentile_norm.ref``, the per-band
percentile helper the public op uses, and the stretch that K5 computes.

``percentiles`` follows ``jnp.percentile``'s linear interpolation along
axis 0 in f32 (the form the reference's jitted op takes): the position is
``f32(p) / 100 * (f32(R) - 1)``, the two order statistics around it come
from one stable sort of each band, and they are interpolated as
``lo * (1 - w) + hi * w``.  ``torch.quantile`` is not used: it refuses
inputs of more than 2**24 elements, and a 2048 x 2048 x 4 scene already
has 16.8M.  A stable sort gives ties to the pixel that comes first, as
the reference's sort does, so gradients land on the same pixels.  A band
holding a NaN gets NaN bounds, as in ``jnp.percentile``.

``stretch_ref`` computes ``(x - lo) * (1 / max(hi - lo, 1e-12))`` and
clamps to [0, 1]: the Pallas kernel's operation order, not the oracle's
division.  A NaN pixel stays NaN.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

EPS = 1e-12   # the kernel's max(hi - lo, 1e-12) guard


def percentiles(x: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """x: (R, C) f32 -> (len(qs), C) f32, each row the ``q``-th percentile
    of every band (``jnp.percentile(x, q, axis=0)``)."""
    R = x.shape[0]
    srt = torch.sort(x, dim=0, stable=True).values
    n = np.float32(R)
    rows = []
    for q in qs:
        # numpy f32 scalars round each step as the reference's f32 ops do
        pos = np.float32(np.float32(q) / np.float32(100)) * (n - np.float32(1))
        lo_i, hi_i = np.floor(pos), np.ceil(pos)
        w_hi = pos - lo_i
        w_lo = np.float32(1) - w_hi
        lo_i = int(min(max(lo_i, 0), R - 1))
        hi_i = int(min(max(hi_i, 0), R - 1))
        rows.append(srt[lo_i] * float(w_lo) + srt[hi_i] * float(w_hi))
    return torch.stack(rows).masked_fill(torch.isnan(x).any(dim=0),
                                         float("nan"))


def stretch_ref(x: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """x: (R, C) any float; lo/hi: (1, C) f32 -> (R, C) f32
    ``clip((x - lo) * (1 / max(hi - lo, 1e-12)), 0, 1)``."""
    lo, hi = lo.float(), hi.float()
    scale = 1.0 / torch.maximum(hi - lo, torch.full_like(hi, EPS))
    return torch.clamp((x.float() - lo) * scale, 0.0, 1.0)


def percentile_normalize_ref(img: torch.Tensor, p_lo: float = 1.0,
                             p_hi: float = 99.0) -> torch.Tensor:
    """img: (..., C) -> f32 in [0, 1], the per-band [p_lo, p_hi] stretch."""
    flat = img.reshape(-1, img.shape[-1]).float()
    pct = percentiles(flat, (p_lo, p_hi))
    return stretch_ref(flat, pct[0:1], pct[1:2]).reshape(img.shape)

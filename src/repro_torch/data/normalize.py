"""Raster normalization on the host (numpy).

The port's own copy of ``repro.data.normalize``: for the same input it
gives the same arrays as the reference.  :func:`percentile_stretch` is the
host oracle of the card's path, ``repro_torch.kernels.percentile_norm``
(kernel K5), and :func:`nir_rg` is the deforestation study's composite."""
from __future__ import annotations

import numpy as np


def percentile_stretch(img: np.ndarray, p_lo: float = 1.0,
                       p_hi: float = 99.0) -> np.ndarray:
    """Per-band [p_lo, p_hi] percentile clamp-and-stretch to [0,1]
    (paper Sect. II-B1)."""
    flat = img.reshape(-1, img.shape[-1]).astype(np.float32)
    lo = np.percentile(flat, p_lo, axis=0)
    hi = np.percentile(flat, p_hi, axis=0)
    out = (flat - lo) / np.maximum(hi - lo, 1e-12)
    return np.clip(out, 0.0, 1.0).reshape(img.shape).astype(np.float32)


def ndvi(img: np.ndarray, red: int = 0, nir: int = 3) -> np.ndarray:
    """Normalized Difference Vegetation Index (paper Sect. II-C2)."""
    r = img[..., red].astype(np.float32)
    n = img[..., nir].astype(np.float32)
    return (n - r) / np.maximum(n + r, 1e-6)


def evi(img: np.ndarray, red: int = 0, blue: int = 2, nir: int = 3
        ) -> np.ndarray:
    """Enhanced Vegetation Index (paper Sect. II-C2)."""
    r = img[..., red].astype(np.float32) / 1e4
    b = img[..., blue].astype(np.float32) / 1e4
    n = img[..., nir].astype(np.float32) / 1e4
    return 2.5 * (n - r) / np.maximum(n + 6 * r - 7.5 * b + 1.0, 1e-6)


def nir_rg(img: np.ndarray, red: int = 0, green: int = 1, nir: int = 3
           ) -> np.ndarray:
    """Color-shifted infrared composite NIR-R-G (paper Sect. II-C2)."""
    return percentile_stretch(np.stack(
        [img[..., nir], img[..., red], img[..., green]], axis=-1))

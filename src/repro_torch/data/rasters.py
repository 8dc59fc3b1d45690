"""Synthetic Sentinel-2-style rasters + ground-truth polygon rasterization.

The paper's pipeline: download L2A rasters (13 bands, we synthesize the
RGB+NIR subset), rasterize CWFIS/PRODES ground-truth polygons into masks,
then normalize and chip.  Real imagery cannot ship in this repo, so
``synth_raster`` generates spatially-correlated multi-band scenes with
burn-scar/deforestation-shaped regions, and ``rasterize_polygons`` is a
real even-odd point-in-polygon rasterizer (the rasterio.rasterize
equivalent).

The port's own copy of ``repro.data.rasters`` (numpy only): the same scene
ids and seeds give the same arrays, bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scene:
    """One raster + its ground-truth mask + provenance id."""
    raster: np.ndarray        # (H, W, C) float32, reflectance-like
    mask: np.ndarray          # (H, W) uint8 {0,1}
    scene_id: str


def _stable_seed(name: str, seed: int) -> int:
    """Process-independent seed (python hash() is randomized per process)."""
    digest = hashlib.sha256(f"{name}:{seed}".encode()).digest()
    return int.from_bytes(digest[:4], "little")


def _smooth_noise(rng, h, w, octaves=4, base=16):
    """Cheap multi-octave value noise via bilinear-upsampled grids."""
    out = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        gh, gw = base * (2 ** o) + 1, base * (2 ** o) + 1
        grid = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
             + grid[y0 + 1][:, x0] * fy * (1 - fx)
             + grid[y0][:, x0 + 1] * (1 - fy) * fx
             + grid[y0 + 1][:, x0 + 1] * fy * fx)
        out += amp * g
        amp *= 0.5
    return out


def _band_effect(h, w, bands, *, red, rest, nir):
    """Per-band spectral shift: band 0 = red, last band = NIR (if >= 4
    bands), everything else = `rest`."""
    eff = np.full((h, w, bands), rest, np.float32)
    eff[:, :, 0] = red
    if bands >= 4:
        eff[:, :, -1] = nir
    return eff


def random_polygon(rng, center, mean_radius, n_vertices=12) -> np.ndarray:
    """Star-convex polygon around `center` (burn scars are blobby)."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, n_vertices))
    radii = mean_radius * rng.uniform(0.5, 1.5, n_vertices)
    xs = center[0] + radii * np.cos(angles)
    ys = center[1] + radii * np.sin(angles)
    return np.stack([xs, ys], axis=1)


def rasterize_polygons(polygons: Sequence[np.ndarray], h: int, w: int
                       ) -> np.ndarray:
    """Even-odd point-in-polygon rasterization -> (h, w) uint8 mask.
    Vectorized per scanline over polygon edges."""
    mask = np.zeros((h, w), bool)
    xs = np.arange(w) + 0.5
    for poly in polygons:
        px, py = poly[:, 0], poly[:, 1]
        qx, qy = np.roll(px, -1), np.roll(py, -1)
        y0 = max(int(np.floor(py.min())), 0)
        y1 = min(int(np.ceil(py.max())) + 1, h)
        for row in range(y0, y1):
            yc = row + 0.5
            cond = (py <= yc) != (qy <= yc)
            if not cond.any():
                continue
            t = (yc - py[cond]) / (qy[cond] - py[cond])
            x_int = px[cond] + t * (qx[cond] - px[cond])
            # even-odd: count crossings left of each pixel center
            crossings = (x_int[None, :] > xs[:, None]).sum(axis=1)
            mask[row] |= (crossings % 2).astype(bool)
    return mask.astype(np.uint8)


def synth_raster(scene_id: str, h: int = 512, w: int = 512, bands: int = 4,
                 n_burns: Tuple[int, int] = (1, 4), seed: int = 0) -> Scene:
    """Synthesize one scene: correlated background + burn polygons that
    darken NIR / redden visible inside the mask (spectrally plausible)."""
    rng = np.random.default_rng(_stable_seed(scene_id, seed))
    base = np.stack([_smooth_noise(rng, h, w) for _ in range(bands)], -1)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    raster = 800 + 2500 * base + rng.normal(0, 60, (h, w, bands))

    n = rng.integers(n_burns[0], n_burns[1] + 1)
    polys = [random_polygon(
        rng, center=(rng.uniform(0.15, 0.85) * w, rng.uniform(0.15, 0.85) * h),
        mean_radius=rng.uniform(0.08, 0.25) * min(h, w))
        for _ in range(n)]
    mask = rasterize_polygons(polys, h, w)

    m = mask.astype(np.float32)[..., None]
    burn_effect = _band_effect(h, w, bands, red=+400.0, rest=-300.0,
                               nir=-900.0)
    raster = raster + m * burn_effect + m * rng.normal(0, 80, (h, w, bands))
    return Scene(raster.astype(np.float32), mask, scene_id)


def synth_change_pair(scene_id: str, h: int = 256, w: int = 256,
                      bands: int = 4, seed: int = 0):
    """Deforestation pair: (before, after, change_mask) — 'after' applies
    clearing polygons to the shared background (PRODES-style)."""
    before = synth_raster(scene_id + "-t0", h, w, bands, (0, 0), seed)
    rng = np.random.default_rng(_stable_seed(scene_id + "-chg", seed))
    n = rng.integers(1, 4)
    polys = [random_polygon(
        rng, center=(rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h),
        mean_radius=rng.uniform(0.06, 0.2) * min(h, w)) for _ in range(n)]
    change = rasterize_polygons(polys, h, w)
    m = change.astype(np.float32)[..., None]
    effect = _band_effect(h, w, bands, red=+600.0, rest=+200.0, nir=-1200.0)
    after = before.raster + m * effect + rng.normal(0, 60, (h, w, bands))
    return before.raster, after.astype(np.float32), change

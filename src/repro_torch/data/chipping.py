"""Sliding-window chipping — the paper's exact recipe (Sect. II-B2):
256x256 windows with 25% overlap; keep only chips with >= `min_frac` of
BOTH classes; de-duplicate redundant chips; split train/val/test *by
raster* ("Instead of blindly splitting our dataset … we chose to split our
dataset by rasters").

The port's own copy of ``repro.data.chipping`` (numpy only): it gives the
same chips, in the same order, as the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Chip:
    image: np.ndarray     # (chip, chip, C) float32
    mask: np.ndarray      # (chip, chip) uint8
    scene_id: str
    y: int
    x: int

    def content_hash(self) -> str:
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(self.image).tobytes())
        h.update(np.ascontiguousarray(self.mask).tobytes())
        return h.hexdigest()


def chip_positions(h: int, w: int, chip: int, overlap: float) -> List[Tuple[int, int]]:
    stride = max(int(chip * (1 - overlap)), 1)
    ys = list(range(0, max(h - chip, 0) + 1, stride))
    xs = list(range(0, max(w - chip, 0) + 1, stride))
    if ys and ys[-1] != h - chip and h >= chip:
        ys.append(h - chip)
    if xs and xs[-1] != w - chip and w >= chip:
        xs.append(w - chip)
    return [(y, x) for y in ys for x in xs]


def make_chips(raster: np.ndarray, mask: np.ndarray, scene_id: str,
               chip: int = 256, overlap: float = 0.25,
               min_frac: float = 0.10) -> List[Chip]:
    """Both-class threshold: paper keeps chips with at least 10% burned AND
    10% unburned pixels."""
    h, w = mask.shape
    out = []
    for y, x in chip_positions(h, w, chip, overlap):
        m = mask[y:y + chip, x:x + chip]
        frac = float(m.mean())
        if frac < min_frac or frac > 1 - min_frac:
            continue
        out.append(Chip(raster[y:y + chip, x:x + chip].copy(), m.copy(),
                        scene_id, y, x))
    return out


def dedup_chips(chips: Sequence[Chip]) -> List[Chip]:
    """Paper: 'There were some redundant rasters that generated redundant
    chips. So we removed the redundant data.'"""
    seen = set()
    out = []
    for c in chips:
        hh = c.content_hash()
        if hh in seen:
            continue
        seen.add(hh)
        out.append(c)
    return out


def split_by_raster(chips: Sequence[Chip],
                    fractions=(0.68, 0.20, 0.12), seed: int = 0
                    ) -> Dict[str, List[Chip]]:
    """Raster-level split; rasters with many chips go to train/val, rasters
    with few chips to test (paper: 'use rasters with a few chips in our
    test set as this will make our test set more diverse')."""
    by_scene: Dict[str, List[Chip]] = {}
    for c in chips:
        by_scene.setdefault(c.scene_id, []).append(c)
    scenes = sorted(by_scene, key=lambda s: -len(by_scene[s]))
    total = sum(len(v) for v in by_scene.values())
    out = {"train": [], "val": [], "test": []}
    budget = {"train": fractions[0] * total, "val": fractions[1] * total}
    for s in scenes:
        cs = by_scene[s]
        if len(out["train"]) < budget["train"]:
            out["train"].extend(cs)
        elif len(out["val"]) < budget["val"]:
            out["val"].extend(cs)
        else:
            out["test"].extend(cs)
    return out


def augment_rotations(chips: Sequence[Chip],
                      angles=(90, 180)) -> List[Chip]:
    """Paper (deforestation): 'rotation augmentation at 90 and 180 degrees
    to increase dataset size'."""
    out = list(chips)
    for c in chips:
        for a in angles:
            k = a // 90
            out.append(Chip(np.rot90(c.image, k).copy(),
                            np.rot90(c.mask, k).copy(),
                            c.scene_id + f"-rot{a}", c.y, c.x))
    return out

"""The port's copies of the vision data pipeline (``repro_torch.data``:
rasters, chipping, normalization, the chip loader) against the JAX
package's modules on the same seeds.  All of it is numpy code, so the
arrays must be equal bit for bit; ``prefetch`` must yield the loader's
batches in order as tensors."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import chipping as jchip  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data import normalize as jnorm  # noqa: E402
from repro.data import rasters as jrast  # noqa: E402
from repro_torch.data import chipping, loader, normalize, rasters  # noqa: E402


def _chips_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.scene_id, x.y, x.x) == (y.scene_id, y.y, y.x)
        np.testing.assert_array_equal(x.image, y.image)
        np.testing.assert_array_equal(x.mask, y.mask)


@pytest.mark.parametrize("seed,bands", [(0, 4), (3, 3), (5, 13)])
def test_synth_raster_bitwise(seed, bands):
    got = rasters.synth_raster("s", 96, 80, bands=bands, seed=seed)
    want = jrast.synth_raster("s", 96, 80, bands=bands, seed=seed)
    np.testing.assert_array_equal(got.raster, want.raster)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.scene_id == want.scene_id


def test_synth_change_pair_and_rasterize_bitwise():
    for a, b in zip(rasters.synth_change_pair("p", 64, 64, seed=2),
                    jrast.synth_change_pair("p", 64, 64, seed=2)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    polys = [rasters.random_polygon(rng, (30.0, 20.0), 12.0)]
    np.testing.assert_array_equal(rasters.rasterize_polygons(polys, 50, 60),
                                  jrast.rasterize_polygons(polys, 50, 60))
    assert rasters._stable_seed("x", 3) == jrast._stable_seed("x", 3)


def _scenes(n=3, size=128):
    return [rasters.synth_raster(f"sc-{i}", size, size, seed=i)
            for i in range(n)]


def test_chipping_pipeline_bitwise():
    chips, jchips = [], []
    for s in _scenes():
        img = normalize.percentile_stretch(s.raster)[..., :3]
        chips += chipping.make_chips(img, s.mask, s.scene_id, chip=32,
                                     overlap=0.25, min_frac=0.05)
        jchips += jchip.make_chips(img, s.mask, s.scene_id, chip=32,
                                   overlap=0.25, min_frac=0.05)
    assert len(chips) > 8
    _chips_equal(chips, jchips)
    dups = chips + chips[:3]
    _chips_equal(chipping.dedup_chips(dups), jchip.dedup_chips(dups))
    for fr in ((0.7, 0.15, 0.15), (0.68, 0.20, 0.12)):
        got = chipping.split_by_raster(chips, fractions=fr)
        want = jchip.split_by_raster(chips, fractions=fr)
        assert set(got) == set(want)
        for k in want:
            _chips_equal(got[k], want[k])
    _chips_equal(chipping.augment_rotations(chips[:4]),
                 jchip.augment_rotations(chips[:4]))
    assert chipping.chip_positions(300, 200, 64, 0.25) == \
        jchip.chip_positions(300, 200, 64, 0.25)


def test_normalize_indices_bitwise():
    raster = _scenes(1, 64)[0].raster
    for name in ("percentile_stretch", "ndvi", "evi", "nir_rg"):
        np.testing.assert_array_equal(getattr(normalize, name)(raster),
                                      getattr(jnorm, name)(raster))


@pytest.mark.parametrize("drop_last", [True, False])
def test_chip_loader_epochs_bitwise(drop_last):
    s = _scenes(1, 128)[0]
    chips = chipping.make_chips(s.raster[..., :3], s.mask, s.scene_id,
                                chip=32, overlap=0.5, min_frac=0.05)
    a = loader.ChipLoader(chips, batch_size=3, seed=4, drop_last=drop_last)
    b = jloader.ChipLoader(chips, batch_size=3, seed=4, drop_last=drop_last)
    assert len(a) == len(b)
    for _ in range(2):
        got, want = list(a.epoch()), list(b.epoch())
        assert len(got) == len(want)
        for (x, m), (y, n) in zip(got, want):
            assert x.dtype == y.dtype and m.dtype == n.dtype
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(m, n)


def test_prefetch_yields_the_loader_batches_in_order():
    s = _scenes(1, 128)[0]
    chips = chipping.make_chips(s.raster[..., :3], s.mask, s.scene_id,
                                chip=32, overlap=0.5, min_frac=0.05)
    want = list(loader.ChipLoader(chips, batch_size=4, seed=1,
                                  drop_last=False).epoch())
    got = list(loader.prefetch(loader.ChipLoader(
        chips, batch_size=4, seed=1, drop_last=False), n=2, device="cpu"))
    assert len(got) == len(want) > 1
    for (x, m), (y, n) in zip(got, want):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), y)
        np.testing.assert_array_equal(m.numpy(), n)
    # dicts of arrays pass through too, and a producer error re-raises
    items = [{"a": np.arange(3)}, {"a": np.arange(3) + 1}]
    out = list(loader.prefetch(items))
    assert [o["a"].tolist() for o in out] == [[0, 1, 2], [1, 2, 3]]

    def bad():
        yield (np.zeros(2),)
        raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match="boom"):
        list(loader.prefetch(bad()))


def test_prefetch_stops_its_thread_when_closed_early():
    before = threading.active_count()
    gen = loader.prefetch(({"i": np.array([i])} for i in range(100)), n=2)
    assert next(gen)["i"].item() == 0
    gen.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before

"""The vision slice end to end on the CPU (``repro_torch.launch.vision``)
against the JAX package's example scripts: the burned-area dataset and
the deforestation pairs (normalized by the port's percentile stretch
where the examples call numpy's) give the examples' chips and
composites; three U-Net steps give the reference's losses; the training
entry points run on the CPU and refuse to run without a card unless given
a device.

Tolerances: normalized images 1e-5 (the reference's own kernel-vs-oracle
tolerance); losses 1e-5 relative.  The step comparison uses SGD, not
Adam: an Adam step moves a parameter by about lr * sign(g) where g is near
zero, so gradients equal to rounding can still move it apart.  Its oracle
is the reference run in f64 (``jax.enable_x64``): the reference's own f32
steps stray from it by 4e-5 of the loss after one step and 3e-4 after
two (its f32 U-Net gradients are that far off), where the port's f32
steps stay within 1e-6 of it.  The port's f64 steps repeat it to 1e-7:
both packages' optimizers do the update in f32, so an f64 gradient that
differs in its last bits can round the new weight to the next f32.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.models import segmentation as jseg  # noqa: E402
from repro.optim import get_optimizer as jax_get_optimizer  # noqa: E402
from repro_torch.convert import vision_params_from_flat  # noqa: E402
from repro_torch.data.loader import ChipLoader  # noqa: E402
from repro_torch.kernels.percentile_norm.kernel import (  # noqa: E402
    percentile_norm_kernel)
from repro_torch.launch import vision  # noqa: E402
from repro_torch.models.segmentation import seg_loss  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def split():
    return vision.build_dataset(4, 128, 32, device="cpu")


def test_build_dataset_gives_the_examples_chips(split):
    want = _example("burned_area_grid").build_dataset(4, 128, 32)
    assert set(split) == set(want)
    assert len(split["train"]) > 8 and len(split["val"]) > 1
    for k in want:
        assert len(split[k]) == len(want[k])
        for a, b in zip(split[k], want[k]):
            assert (a.scene_id, a.y, a.x) == (b.scene_id, b.y, b.x)
            np.testing.assert_array_equal(a.mask, b.mask)
            np.testing.assert_allclose(a.image, b.image, atol=1e-5, rtol=0)


def test_build_dataset_shows_each_normalized_scene():
    seen = []
    vision.build_dataset(2, 64, 32, device="cpu",
                         on_scene=lambda s, n: seen.append((s, n)))
    from repro_torch.data.normalize import percentile_stretch
    assert [s.scene_id for s, _ in seen] == ["ba-scene-0", "ba-scene-1"]
    for s, n in seen:
        np.testing.assert_allclose(n.numpy(), percentile_stretch(s.raster),
                                   atol=1e-5, rtol=0)


def test_build_pairs_gives_the_examples_composites():
    want = _example("deforestation_changeformer").build_pairs(3, 48)
    got = vision.build_pairs(3, 48, device="cpu")
    for (a, b, m), (wa, wb, wm) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), wa, atol=1e-5, rtol=0)
        np.testing.assert_allclose(b.numpy(), wb, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(m.numpy(), wm)
        assert m.dtype == torch.int32


def test_unet_sgd_steps_match_jax(split):
    """Three U-Net steps (SGD, lr 0.05) on the loader's batches: the
    losses agree with the same steps of the reference on the same
    weights."""
    jp0 = jseg.seg_init("unet", jax.random.PRNGKey(0), width=8)
    batches = list(ChipLoader(split["train"], batch_size=4, seed=0).epoch())
    assert len(batches) >= 3
    jopt = jax_get_optimizer("sgd")
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: np.asarray(a, np.float64), jp0)
        js = jopt.init(jp)

        @jax.jit
        def jstep(p, s, i, x, m):
            loss, g = jax.value_and_grad(lambda p: jseg.seg_loss(
                "unet", p, x, m))(p)
            return *jopt.update(g, s, p, i, 0.05), loss
        want = []
        for i, (x, m) in enumerate(batches[:3]):
            jp, js, loss = jstep(jp, js, i, x.astype(np.float64), m)
            want.append(float(loss))
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-7)):
        params = vision_params_from_flat(_flatten(jp0), device="cpu",
                                         dtype=dtype)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        opt = get_optimizer("sgd")
        state = opt.init(params)
        for i, (x, m) in enumerate(batches[:3]):
            loss = vision.train_step(
                lambda p: seg_loss("unet", p, torch.from_numpy(x).to(dtype),
                                   torch.from_numpy(m)), params, opt, state,
                i, 0.05)
            assert loss.item() == pytest.approx(want[i], rel=rel), (dtype, i)


def test_train_segmentation_on_cpu(split):
    n0 = percentile_norm_kernel.launches
    res = vision.train_segmentation("deeplabv3plus", split, lr=1e-2,
                                    optimizer="lamb", epochs=1, batch=8,
                                    width=4, device="cpu")
    assert res["steps"] == -(-len(split["train"]) // 8)
    assert len(res["losses"]) == res["steps"]
    assert np.all(np.isfinite(res["losses"]))
    for k in ("precision", "recall", "f1", "iou", "accuracy"):
        assert 0.0 <= res[k] <= 1.0
    assert percentile_norm_kernel.launches == n0   # no kernel on the CPU


def test_train_changeformer_on_cpu():
    pairs = vision.build_pairs(5, 32, device="cpu")
    res = vision.train_changeformer(pairs, steps=3, device="cpu")
    assert res["params"] == 324258 and len(res["losses"]) == 3
    assert np.all(np.isfinite(res["losses"]))
    assert 0.0 <= res["accuracy"] <= 1.0
    with pytest.raises(ValueError, match="none to test"):
        vision.train_changeformer(pairs[:4], steps=1, device="cpu")


def test_entry_points_need_a_card_or_a_device(split, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.build_dataset(1, 32, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.train_segmentation("unet", split, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.build_pairs(1, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.main(["--scenes", "1"])


def test_main_on_cpu(capsys):
    out = vision.main(["--device", "cpu", "--scenes", "4", "--size", "96",
                       "--chip", "32", "--epochs", "1", "--models",
                       "unet,unetpp", "--pairs", "5", "--pair-size", "32",
                       "--cf-steps", "2"])
    assert out["device"] == "cpu" and out["percentile_norm_launches"] == 0
    assert [m["model"] for m in out["models"]] == ["unet", "unetpp"]
    assert np.isfinite(out["changeformer"]["final_loss"])
    assert '"changeformer"' in capsys.readouterr().out

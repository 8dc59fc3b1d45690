"""The port's analysis kinds against the JAX package's: the analytic cost
model (``repro_torch.analysis.analytic``) and ``model_flops`` equal the
reference's to rel 1e-12 for every arch x ``INPUT_SHAPES`` cell x layout
x mesh (one pod, two pods, one chip), with the same hardware figures
passed to both; and the tables and config tweaks the dry run and the
probe share (``INPUT_SHAPES``, ``STRUCTURAL_SKIPS``, ``BIG_PARAM_THRESHOLD``,
``effective_config``, ``pick_optimizer``'s moment dtype) equal the
reference's."""
import ast
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import analytic as RA  # noqa: E402
from repro.analysis import roofline as RR  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import mesh as RM  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro_torch.analysis import analytic as TA  # noqa: E402
from repro_torch.analysis import roofline as TR  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LAYOUTS = ("dp", "fsdp_tp", "fsdp_sp")
DIMS = {"single_pod": {"data": 16, "model": 16},
        "two_pods": {"pod": 2, "data": 16, "model": 16},
        "one_chip": {"data": 1, "model": 1}}
# one set of hardware figures handed to both packages
HW = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
KINDS = ("train", "prefill", "decode")


def _close(a, b, path="") -> None:
    """Equal structure; numbers within rel 1e-12, strings equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, str):
        assert a == b, path
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=0), path


def _cfgs(arch, shape):
    return (RS.effective_config(jax_config(arch), shape),
            TS.effective_config(get_config(arch), shape))


def test_input_shapes_skips_and_thresholds_equal_the_reference():
    assert TM.INPUT_SHAPES == RM.INPUT_SHAPES
    # the reference's module sets XLA's fake-device flag when imported,
    # so its table is read from the source
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    skips = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "STRUCTURAL_SKIPS")
    assert TD.STRUCTURAL_SKIPS == skips
    assert TS.BIG_PARAM_THRESHOLD == RS.BIG_PARAM_THRESHOLD
    assert TM.production_dims() == {"data": 16, "model": 16}
    assert TM.production_dims(True) == {"pod": 2, "data": 16, "model": 16}


def test_h100_defaults():
    """The port's defaults are the card's figures, not the TPU's."""
    cfg = get_config("stablelm-1.6b")
    explicit = TA.analytic_roofline(cfg, 256, 4096, "train",
                                    DIMS["single_pod"], **HW)
    assert TA.analytic_roofline(cfg, 256, 4096, "train",
                                DIMS["single_pod"]) == explicit
    assert (TR.HW.peak_flops, TR.HW.hbm_bw, TR.HW.link_bw) == (
        HW["peak_flops"], HW["hbm_bw"], HW["link_bw"])


@pytest.mark.parametrize("arch", list_archs())
def test_effective_config_and_optimizer_dtype(arch):
    for shape in TM.INPUT_SHAPES:
        ref, port = _cfgs(arch, shape)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), shape
    cfg = get_config(arch)
    moments = tree_leaves(TS.pick_optimizer(cfg).init(
        {"w": torch.zeros(2)}))
    want = (torch.bfloat16 if cfg.param_count() > RS.BIG_PARAM_THRESHOLD
            else torch.float32)
    assert moments and {t.dtype for t in moments} == {want}


@pytest.mark.parametrize("shape", list(RM.INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_analytic_model_equals_the_reference(arch, shape):
    seq, batch, kind = RM.INPUT_SHAPES[shape]
    ref_cfg, cfg = _cfgs(arch, shape)
    for name, dims in DIMS.items():
        rmd = RA.mesh_dims(SimpleNamespace(shape=dims))
        tmd = TA.mesh_dims(dims)
        assert dataclasses.astuple(tmd) == dataclasses.astuple(rmd)
        assert tmd.chips == rmd.chips
        for k in KINDS:
            _close(TA.flops_forward(cfg, batch, seq, k),
                   RA.flops_forward(ref_cfg, batch, seq, k))
            for remat in (True, False):
                _close(TA.flops_per_chip(cfg, batch, seq, k, tmd, remat),
                       RA.flops_per_chip(ref_cfg, batch, seq, k, rmd, remat))
        _close(TA.decode_state_bytes(cfg, batch, seq),
               RA.decode_state_bytes(ref_cfg, batch, seq))
        _close(TR.model_flops(cfg, batch, seq, kind),
               RR.model_flops(ref_cfg, batch, seq, kind))
        for layout in LAYOUTS:
            what = f"{name} {layout}"
            _close(TA.hbm_bytes_per_chip(cfg, batch, seq, kind, tmd, layout),
                   RA.hbm_bytes_per_chip(ref_cfg, batch, seq, kind, rmd,
                                         layout), what)
            _close(TA.collective_bytes_per_chip(cfg, batch, seq, kind, tmd,
                                                layout),
                   RA.collective_bytes_per_chip(ref_cfg, batch, seq, kind,
                                                rmd, layout), what)
            _close(TA.analytic_roofline(cfg, batch, seq, kind, dims, layout,
                                        **HW),
                   RA.analytic_roofline(ref_cfg, batch, seq, kind,
                                        SimpleNamespace(shape=dims), layout,
                                        **HW), what)


def test_profile_terms():
    """Three terms from the analytic FLOPs and bytes and the counted
    collective bytes; the dominant one bounds the step."""
    t = TR.profile_terms(0.5, 989e12 * 0.25, 3.35e12 * 0.1, 450e9 * 0.01)
    assert t["compute_s"] == pytest.approx(0.25)
    assert t["memory_s"] == pytest.approx(0.1)
    assert t["collective_s"] == pytest.approx(0.01)
    assert t["dominant"] == "compute_s"
    assert t["step_time_lower_bound_s"] == pytest.approx(0.25)
    assert t["bound_share"] == pytest.approx(0.5)


def test_device_profile_needs_a_card(monkeypatch):
    from repro_torch.analysis import device_profile
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_profile(lambda: None)

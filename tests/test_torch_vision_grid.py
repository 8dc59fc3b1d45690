"""The burned-area grid (``repro_torch.launch.vision_grid``)
against the reference's ``examples/burned_area_grid.py``, imported by
path and run by its own ``main`` on the same split with the same stub
payload (fixed metrics by config, so both rank and select on equal
numbers without training): the grid's spec names and params, the staged
config and manifest bytes, each job's env, resources, simulated duration
and labels (the manifests after mapping the container module
``repro_torch.launch.train`` to ``repro.launch.train``), the
orchestrator summary, every job's result, the ranking
and best config the example prints, and ``simulate()``'s makespan and
speedup.  Then one run of the grid's own payload on the CPU at a tiny
size: three 96 x 96 scenes (split by raster, two give no val chips), a
U-Net of width 4, one epoch: six jobs succeed, F1 and IoU in [0, 1]."""
import contextlib
import dataclasses
import importlib.util
import io
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import vision_grid as G  # noqa: E402
from repro_torch.launch.vision import build_dataset  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent


def _example():
    spec = importlib.util.spec_from_file_location(
        "burned_area_grid", ROOT / "examples" / "burned_area_grid.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# fixed val metrics by (lr, optimizer): distinct F1s, one best
F1 = {("0.01", "adam"): 0.41, ("0.01", "lamb"): 0.47,
      ("0.001", "adam"): 0.62, ("0.001", "lamb"): 0.58,
      ("0.0001", "adam"): 0.33, ("0.0001", "lamb"): 0.29}


def stub(lr="1e-3", optimizer="adam", **kw):
    f1 = F1[(lr, optimizer)]
    return {"f1": f1, "iou": f1 / (2 - f1)}


def _files(root: Path, sub: str) -> dict:
    return {p.name: p.read_bytes()
            for p in sorted((root / "repro-data" / sub).iterdir())}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The example's ``main`` and ``run_grid``, each on its own workdir,
    the stub payload in both; the example's orchestrator kept."""
    ex = _example()
    split = {"train": [], "val": [], "test": []}
    ref_dir = tmp_path_factory.mktemp("example")
    kept = []

    class Kept(ex.Orchestrator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    ex.build_dataset = lambda: split
    ex.make_payload = lambda s: stub
    ex.Orchestrator = Kept
    ex.tempfile = types.SimpleNamespace(
        TemporaryDirectory=lambda: contextlib.nullcontext(str(ref_dir)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ex.main()
    port_dir = tmp_path_factory.mktemp("port")
    got = G.run_grid(split, workdir=str(port_dir), payload=stub)
    return dict(orch=kept[0], printed=out.getvalue(), ref_dir=ref_dir,
                port_dir=port_dir, got=got)


def test_specs_and_staged_bytes_equal_the_example(both):
    ref = both["orch"]
    assert [s["name"] for s in both["got"]["specs"]] == list(ref.records)
    assert _files(both["port_dir"], "configs") == _files(both["ref_dir"],
                                                         "configs")
    # the manifests name each package's container module
    assert {k: v.replace(b"repro_torch.launch.", b"repro.launch.")
            for k, v in _files(both["port_dir"], "manifests").items()} == \
        _files(both["ref_dir"], "manifests")
    params = {s["name"]: s["params"] for s in both["got"]["specs"]}
    assert params == {n: {k: float(v) if k == "lr" else v
                          for k, v in r.spec.env.items()}
                      for n, r in ref.records.items()}


def test_jobs_equal_the_example(both):
    want = [{"name": r.spec.name, "env": r.spec.env,
             "resources": dataclasses.asdict(r.spec.resources),
             "duration_h": r.spec.duration_h, "labels": r.spec.labels}
            for r in both["orch"].records.values()]
    assert both["got"]["jobs"] == want
    assert both["got"]["summary"] == both["orch"].summary()
    assert both["got"]["results"] == {
        n: r.result for n, r in both["orch"].records.items()}
    assert set(both["got"]["states"].values()) == {"Succeeded"}


def test_best_config_and_ranking_equal_the_example(both):
    """The configs the example prints, in its order (by val F1), and its
    best."""
    printed = both["printed"]
    order = re.findall(r"^  (\S+)\s+F1=", printed, re.M)
    best = re.search(r"best config: (\S+)", printed).group(1)
    assert both["got"]["ranking"] == order
    assert both["got"]["best"] == best == "ba-unet-lr0p001-optimizeradam"


def test_simulation_equals_the_example(both):
    sim = both["orch"].simulate()
    assert both["got"]["makespan_h"] == sim.makespan_h
    assert both["got"]["speedup_vs_serial"] == sim.speedup_vs_serial()
    m = re.search(r"makespan=([\d.]+)h speedup vs serial=([\d.]+)x",
                  both["printed"])
    assert f"{both['got']['makespan_h']:.2f}" == m.group(1)
    assert f"{both['got']['speedup_vs_serial']:.1f}" == m.group(2)


def test_grid_trains_on_the_cpu(tmp_path):
    """The grid's own payload (``train_segmentation``) end to end."""
    split = build_dataset(3, 96, 64, device="cpu")
    assert split["val"]
    got = G.run_grid(split, device="cpu", width=4, batch=4, epochs=1,
                     workdir=str(tmp_path))
    assert got["summary"]["states"] == {"Succeeded": 6}
    assert len(got["results"]) == 6
    for res in got["results"].values():
        assert 0.0 <= res["f1"] <= 1.0 and 0.0 <= res["iou"] <= 1.0
        assert res["steps"] == 2 and res["wall_s"] > 0
    assert got["best"] == got["ranking"][0]

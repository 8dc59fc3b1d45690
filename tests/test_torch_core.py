"""The port's campaign layer (``repro_torch.core``, ``launch/submit.py``,
the ``simulate`` runner) against the reference's (``repro.core``).

* ``autobatch`` gives the reference's batch for every ported arch under
  explicit budgets; the port's budget has no default size.
* ``ClusterSim`` schedules the same JobSpecs to the same records under
  each placement policy, with and without preemption and checkpoints,
  and with requests tightened by ``LearnedRequests``.
* Manifests and YAML are the reference's text; ``run simulate`` gives the
  reference's metrics for each campaign and all three (the paper's 234
  jobs and 4040.0 wall-hours), with manifests equal file by file.  A
  manifest's container command names each package's own training module
  (``repro.launch.train`` there, ``repro_torch.launch.train`` here); that
  one token is mapped before the texts are compared.
* ``Orchestrator.run_local`` keeps the reference's records for toy
  runners, a flaky one included, and runs a two-job grid of the real
  ``train`` runner on the CPU through a preemption, a resumed retry and
  the S3 export.

Equality is exact throughout: the same Python arithmetic in both.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as J  # noqa: E402
import repro.core as JC  # noqa: E402
import repro_torch.api as T  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro.api import registry as jregistry  # noqa: E402
from repro.checkpoint.io import export_to_s3 as jax_export  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.autobatch import MemoryBudget as JBudget  # noqa: E402
from repro.core.autobatch import autobatch as jax_autobatch  # noqa: E402
from repro.core.placement import \
    gang_rank_capacity as jax_capacity  # noqa: E402
from repro.launch.submit import \
    build_campaign_runs as jax_campaign  # noqa: E402
from repro_torch.api import registry as tregistry  # noqa: E402
from repro_torch.checkpoint import export_to_s3  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.autobatch import MemoryBudget, autobatch  # noqa: E402
from repro_torch.core.placement import gang_rank_capacity  # noqa: E402
from repro_torch.launch.submit import build_campaign_runs  # noqa: E402

MODULES = (b"repro.launch.train", b"repro_torch.launch.train")
CAMPAIGNS = ("burned_area", "detection", "deforestation", "all")


def _ref_text(data: bytes) -> bytes:
    """A reference manifest with its container module mapped to the
    port's."""
    return data.replace(*MODULES)


# -------------------------------------------------------------- autobatch
@pytest.mark.parametrize("arch", list_archs())
def test_autobatch_matches_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for gb in (11.0, 16.0, 24.0, 80.0, 640.0):
        for seq in (512, 2048, 8192):
            for remat in (True, False):
                for shards in (1, 8):
                    kw = dict(n_shards=shards, act_shards=shards,
                              remat=remat)
                    assert autobatch(cfg, seq, budget=MemoryBudget(gb),
                                     **kw) == jax_autobatch(
                        jcfg, seq, budget=JBudget(device_gb=gb), **kw)


def test_the_budget_comes_from_the_card():
    with pytest.raises(TypeError):
        MemoryBudget()                         # no size by default
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            autobatch(get_config("stablelm-1.6b"), 2048)


# ------------------------------------------------------------- scheduler
def _jobs(pkg_core, n=40, seed=3, learned=None):
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n):
        res = pkg_core.Resources(
            gpus=int(rng.choice([0, 1, 2, 4, 8])),
            cpus=int(rng.integers(1, 33)),
            memory_gb=float(rng.choice([4.0, 24.0, 48.0, 200.0])),
            gpu_memory_gb_min=float(rng.choice([0.0, 0.0, 24.0, 40.0])))
        kind = ("train", "serve")[i % 2]
        if learned is not None:
            res = learned.effective(kind, res)
        jobs.append(pkg_core.JobSpec(
            name=f"j{i}", resources=res, retries=int(rng.integers(0, 4)),
            priority=int(rng.integers(0, 3)),
            duration_h=float(rng.uniform(0.2, 30.0))))
    return jobs


def _learned(pkg_core):
    learned = pkg_core.LearnedRequests(min_samples=3)
    rng = np.random.default_rng(7)
    for kind in ("train", "serve"):
        for _ in range(5):
            learned.observe(kind, cpus=float(rng.uniform(0.5, 6.0)),
                            memory_gb=float(rng.uniform(0.1, 12.0)))
    return learned


def _sim_view(res):
    recs = [(r.spec.name, r.state.value, r.node, r.attempts, r.start_time,
             r.end_time) for r in res.records]
    d = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
         if f.name != "records"}
    return d, recs


@pytest.mark.parametrize("placement", ["best_fit", "worst_fit", "pack"])
@pytest.mark.parametrize("learned", [False, True])
def test_cluster_sim_matches_the_reference(placement, learned):
    for rate, ckpt in ((0.0, 0.0), (0.3, 0.0), (0.3, 2.0)):
        views = []
        for core in (JC, TC):
            lr = _learned(core) if learned else None
            sim = core.ClusterSim(seed=11, preemption_rate=rate,
                                  checkpoint_every_h=ckpt,
                                  placement=placement)
            views.append(_sim_view(sim.run(_jobs(core, learned=lr))))
        assert views[1] == views[0], (rate, ckpt)
        if rate:
            assert views[1][0]["preemptions"] > 0


def test_learned_requests_and_placement_match_the_reference():
    j, t = _learned(JC), _learned(TC)
    assert t.snapshot() == j.snapshot()
    for job in _jobs(JC, n=10):
        res = job.resources
        tres = TC.Resources(**dataclasses.asdict(res))
        assert (dataclasses.asdict(t.effective("train", tres))
                == dataclasses.asdict(j.effective("train", res)))
    # the policies order the same free nodes the same way
    jsim, tsim = JC.ClusterSim(), TC.ClusterSim()
    rng = np.random.default_rng(5)
    for sim in (jsim, tsim):
        r2 = np.random.default_rng(5)
        for n in sim.nodes:
            n.gpus_free = int(r2.integers(0, n.spec.gpus + 1))
            n.cpus_free = int(r2.integers(0, n.spec.cpus + 1))
            n.mem_free = float(r2.uniform(0, n.spec.memory_gb))
    for _ in range(20):
        res = dict(gpus=int(rng.integers(0, 3)), cpus=int(rng.integers(1, 9)),
                   memory_gb=float(rng.uniform(1, 64)))
        for name in TC.PLACEMENT_POLICIES:
            jr, tr = JC.Resources(**res), TC.Resources(**res)
            jo = JC.get_placement_policy(name).order(jsim.nodes, jr)
            to = TC.get_placement_policy(name).order(tsim.nodes, tr)
            assert [n.name for n in to] == [n.name for n in jo]
            assert ([gang_rank_capacity(n, tr, 4) for n in to]
                    == [jax_capacity(n, jr, 4) for n in jo])
    with pytest.raises(ValueError):
        TC.get_placement_policy("first_fit")


def test_nodes_json_matches_the_reference():
    obj = {"nodes": [n.to_dict() for n in JC.NAUTILUS_INVENTORY]}
    assert ([n.to_dict() for n in TC.node_specs_from_json(obj)]
            == [n.to_dict() for n in JC.node_specs_from_json(obj)])
    with pytest.raises(ValueError):
        TC.node_specs_from_json({"nodes": obj["nodes"] * 2})


# ------------------------------------------------------- manifests, YAML
def test_manifests_and_yaml_match_the_reference():
    from repro.core.templating import to_yaml as jax_yaml
    from repro_torch.core.templating import to_yaml
    kw = dict(experiment="ba-unet", env={"LR": "1e-4", "NOTE": "a: b",
                                         "EMPTY": "", "Q": '"x"'},
              gpus=2, cpus=4, memory_gb=24.5, retries=5, pvc="data-x")
    for module in (None, "some.module"):
        extra = {"module": module} if module else {}
        got = to_yaml(TC.render_job_manifest("j-1", **kw, **extra))
        want = jax_yaml(JC.render_job_manifest("j-1", **kw, **extra))
        assert got.encode() == (want.encode() if module
                                else _ref_text(want.encode()))
    tree = {"a": [1, 2.5, True, None, {"b": []}], "c": {}, "d": " pad "}
    assert to_yaml(tree) == jax_yaml(tree)
    job = T.RunSpec(kind="train", overrides={"world_size": 4}).to_job()
    assert job.manifest() == J.RunSpec(
        kind="train", overrides={"world_size": 4}).to_job().manifest()


# -------------------------------------------------------------- simulate
def test_campaign_runs_match_the_reference():
    for name in CAMPAIGNS[:3]:
        assert ([r.to_dict() for r in build_campaign_runs(name)]
                == [r.to_dict() for r in jax_campaign(name)])
    with pytest.raises(ValueError):
        build_campaign_runs("segmentation")


@pytest.mark.parametrize("campaign", CAMPAIGNS)
def test_run_simulate_matches_the_reference(campaign, tmp_path):
    for rate, ckpt in ((0.0, 0.0), (0.25, 1.0)):
        out = {}
        for pkg in (J, T):
            wd = tmp_path / f"{pkg.__name__}-{rate}"
            r = pkg.run(pkg.RunSpec(kind="simulate", overrides={
                "campaign": campaign, "workdir": str(wd),
                "preemption_rate": rate, "checkpoint_every_h": ckpt}))
            assert r.ok, r.error
            files = {p.relative_to(wd): p.read_bytes()
                     for p in sorted(wd.rglob("*")) if p.is_file()}
            out[pkg] = (r.metrics, files)
        (jm, jfiles), (tm, tfiles) = out[J], out[T]
        assert tm == jm
        assert sorted(tfiles) == sorted(jfiles)
        for path, data in tfiles.items():
            assert data == _ref_text(jfiles[path]), path
        if campaign == "all" and rate == 0.0:
            assert tm["jobs"] == tm["manifests"] == 234
            assert tm["total_wall_hours"] == 4040.0
        if rate:
            assert tm["preemptions"] > 0


def test_submit_main_and_manifests_mode(tmp_path, capsys, monkeypatch):
    """``launch.submit``'s shim prints the reference's output; the
    ``manifests`` mode only renders; a bad mode fails the run."""
    from repro.launch.submit import main as jax_submit_main
    from repro_torch.launch.submit import main as submit_main
    args = ["--campaign", "detection", "--workdir"]
    submit_main(args + [str(tmp_path / "t")])
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["submit"] + args + [str(tmp_path / "j")])
    jax_submit_main()
    assert got == capsys.readouterr().out
    assert json.loads(got[got.index("{"):])["total_wall_hours"] == 2142.0
    r = T.run(T.RunSpec(kind="simulate", overrides={
        "campaign": "deforestation", "mode": "manifests",
        "workdir": str(tmp_path / "m")}))
    assert r.ok and r.metrics == {"jobs": 60, "manifests": 60}
    bad = T.run(T.RunSpec(kind="simulate", overrides={"mode": "apply"}))
    assert bad.status == "failed" and "mode must be" in bad.error


# ---------------------------------------------------------- orchestrator
@pytest.fixture
def toy_kinds():
    added = []

    def register(kind, make):
        for pkg, reg in ((J, jregistry), (T, tregistry)):
            reg.register_runner(kind, make(pkg))
        added.append(kind)
    yield register
    for reg in (jregistry, tregistry):
        for kind in added:
            reg._RUNNERS.pop(kind, None)


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("wall_s", "serial_s", "simulated_makespan_s",
                             "lane_busy_s", "lane")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def test_run_local_matches_the_reference(toy_kinds, tmp_path):
    """Registry payloads (a steady toy and a flaky one that fails its
    first two attempts per job) and a plain JobSpec payload, through
    ``submit_runs`` / ``submit`` and ``run_local(parallelism=2)``:
    states, attempts, attempt history (without times), results on the
    PVC and in S3, manifests and the lane summary's keys."""
    def make(pkg):
        calls = {}

        def fit(spec):
            return pkg.RunReport(kind=spec.kind, name=spec.run_name,
                                 metrics={"loss": 1.0 / (1.0 + float(
                                     spec.overrides["lr"]))})

        def flaky(spec):
            calls[spec.run_name] = calls.get(spec.run_name, 0) + 1
            if calls[spec.run_name] < 3:
                raise RuntimeError(f"preempted #{calls[spec.run_name]}")
            return pkg.RunReport(kind=spec.kind, name=spec.run_name,
                                 metrics={"resumed_from_step": 2})
        return {"fit": fit, "flaky": flaky}

    toy_kinds("torch-core-fit", lambda pkg: make(pkg)["fit"])
    toy_kinds("torch-core-flaky", lambda pkg: make(pkg)["flaky"])
    views = {}
    for pkg, core in ((J, JC), (T, TC)):
        root = tmp_path / pkg.__name__
        pvc, s3 = core.PersistentVolume(root), core.S3Store(root)
        orch = core.Orchestrator(pvc, s3)
        grid = core.ExperimentGrid("toy", {"lr": [0.1, 1.0, 10.0]})
        orch.submit_runs(grid.to_runs(kind="torch-core-fit"),
                         attach_payload=True)
        orch.submit_runs([pkg.RunSpec(kind="torch-core-flaky", name=n)
                          for n in ("f1", "f2")], attach_payload=True)
        orch.submit(core.JobSpec(name="doomed", retries=1,
                                 payload=lambda **env: 1 / 0))
        with pytest.raises(ValueError):
            orch.submit(core.JobSpec(name="doomed"))
        recs = orch.run_local(parallelism=2)
        files = {str(p.relative_to(root)): p.read_bytes()
                 for p in sorted(root.rglob("*")) if p.is_file()}
        results = {k: _strip_times(json.loads(v)) for k, v in files.items()
                   if k.endswith(".json")}
        views[pkg] = dict(
            states={n: (r.state.value, r.attempts, r.error)
                    for n, r in recs.items()},
            files=sorted(files),
            manifests={k: v for k, v in files.items()
                       if k.startswith("repro-data/manifests/")},
            results=results, summary=orch.summary(),
            lanes=sorted(json.loads(files[
                "repro-data/results/_local_run_summary.json"])))
        if pkg is T:           # the campaign executor is not ported yet
            with pytest.raises(NotImplementedError):
                orch.run_cluster()
    j, t = views[J], views[T]
    assert t["states"] == j["states"]
    assert t["states"]["f1"] == ("Succeeded", 3, None)
    assert t["states"]["doomed"][:2] == ("Failed", 2)
    assert t["files"] == j["files"]
    assert t["results"] == j["results"]
    assert t["summary"] == j["summary"]
    assert t["lanes"] == j["lanes"]
    for k, v in t["manifests"].items():
        assert v == _ref_text(j["manifests"][k]), k
    hist = t["results"]["repro-data/results/f2.json"]["attempt_history"]
    assert [h["outcome"] for h in hist] == ["failed", "failed", "succeeded"]
    assert hist[-1]["resumed_from_step"] == 2


def test_export_to_s3_matches_the_reference(tmp_path):
    src = tmp_path / "ck"
    for rel in ("step_2/manifest.json", "step_2/shard_0.npz",
                ".tmp-step_4/manifest.json", "step_4/.old-x/a", "top.txt"):
        p = src / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(rel.encode())
    stores = [core.S3Store(tmp_path / name)
              for core, name in ((JC, "j"), (TC, "t"))]
    assert (export_to_s3(str(src), stores[1], "models/x")
            == jax_export(str(src), stores[0], "models/x") == 3)
    assert stores[1].list() == stores[0].list()
    assert stores[1].get_bytes("models/x/step_2/shard_0.npz") == \
        b"step_2/shard_0.npz"


def test_pvc_quota_and_escape_match_the_reference(tmp_path):
    for core in (JC, TC):
        pvc = core.PersistentVolume(tmp_path / core.__name__, quota_gb=1e-8)
        pvc.stage_bytes("a.bin", b"x" * 8)
        with pytest.raises(IOError):
            pvc.stage_bytes("b.bin", b"x" * 8)
        with pytest.raises(ValueError):
            pvc.path("../outside")


def test_run_local_trains_a_grid_through_preemption_and_s3(tmp_path):
    """Two learning rates of reduced stablelm-1.6b through the real
    ``train`` runner on the CPU: each job's first attempt is preempted
    before step 3, the retry resumes from step 2 under the retry env, and
    the checkpoint directory is exported to S3."""
    pvc, s3 = TC.PersistentVolume(tmp_path), TC.S3Store(tmp_path)
    grid = TC.ExperimentGrid("lm", {"lr": [3e-4, 1e-3]})
    runs = [r.replace(overrides={
        **r.overrides, "steps": 4, "batch": 2, "seq": 16, "log_every": 0,
        "checkpoint_every": 2, "preempt_at_step": 3, "device": "cpu",
        "checkpoint_dir": str(tmp_path / "ck" / r.run_name),
        "s3_root": str(tmp_path / "s3")})
        for r in grid.to_runs(kind="train", arch="stablelm-1.6b")]
    orch = TC.Orchestrator(pvc, s3)
    recs = orch.submit_runs(runs, attach_payload=True)
    assert all(r.spec.retry_env["RESUME"] == "true" for r in recs)
    orch.run_local()
    for run in runs:
        rec = orch.records[run.run_name]
        assert (rec.state.value, rec.attempts) == ("Succeeded", 2)
        res = json.loads(pvc.read_bytes(f"results/{run.run_name}.json"))
        hist = res["attempt_history"]
        assert [h["outcome"] for h in hist] == ["failed", "succeeded"]
        assert hist[0]["error"].startswith("RuntimeError: Preemption")
        assert hist[1]["resumed_from_step"] == 2
        metrics = res["result"]["metrics"]
        assert metrics["s3_objects"] > 0 and len(metrics["losses"]) == 2
        assert np.all(np.isfinite(metrics["losses"]))
        assert s3.exists(f"results/{run.run_name}.json")
    assert len(pvc.listdir("logs")) == 2

"""The port's run API (``repro_torch.api``, ``python -m repro_torch.launch``)
against the reference's (``repro.api``, ``repro.launch``).

* The reference's argv gives the same RunSpec in both packages: dict,
  JSON, env manifests (both ways), the cluster job with its retry env,
  hash and run name; and the paper's 144-run grid gives the same specs.
* The registries behave alike: the typo guard, a runner's exception as a
  ``failed`` report, env prerequisites, unknown kinds, the five kinds.
* The whole slice across packages: a reduced stablelm-1.6b run is
  preempted under the reference's ``run``, and the port's ``run`` resumes
  the same spec from that checkpoint directory; its losses equal the
  reference's uninterrupted run's for the same steps (rtol 1e-5: the same
  f32 model in another framework, as ``test_torch_train.py``).  SGD,
  because Adam-updated parameters are no oracle.
* The port's runners equal direct ``train_main`` / ``serve_main`` calls,
  and the CLI's exit codes (two subprocess tests).

Everything runs reduced, on the CPU (``device="cpu"``).
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import repro.api as J  # noqa: E402
import repro_torch.api as T  # noqa: E402
from repro.api import registry as jregistry  # noqa: E402
from repro.core import Resources as JResources  # noqa: E402
from repro.core.experiment import \
    paper_burned_area_grid as jax_paper_grid  # noqa: E402
from repro_torch.api import registry as tregistry  # noqa: E402
from repro_torch.api.runners.train import port_backend  # noqa: E402
from repro_torch.core import Resources  # noqa: E402
from repro_torch.core.experiment import paper_burned_area_grid  # noqa: E402
from repro_torch.launch.__main__ import main as launch_main  # noqa: E402
from repro_torch.launch.serve import serve_main  # noqa: E402
from repro_torch.launch.train import train_main  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIVE = ["dryrun", "perfprobe", "serve", "simulate", "train"]
SMALL = {"steps": 3, "batch": 2, "seq": 16, "log_every": 0}

# argv as the reference's CLI takes it, with the resources and labels a
# campaign would attach
ARGVS = [
    (["train"], None, None),
    (["train", "--full", "--steps", "3", "--precision", "bf16"], None, None),
    (["train", "--lr=1e-05", "--batch_size=16", "--dataset", "norm_rgb",
      "--init", "imagenet", "--optimizer", "lamb"],
     {"gpus": 2, "cpus": 4, "memory_gb": 24}, {"experiment": "ba-unet"}),
    (["train", "--tag", '"8"', "--note=\"true\"", "--flag", "--resume"],
     None, {"priority": "3"}),
    (["train", "--world-size", "2", "--gang_min", "1", "--name", "gang-x",
      "--seed", "9"], {"gpus": 1, "cpus": 8, "memory_gb": 48.5,
                       "gpu_memory_gb_min": 40.0}, None),
    (["serve", "--arch", "mamba2-2.7b", "--requests", "8",
      "--arrival-rate", "2.5", "--trace", "bursty"], None, None),
    (["simulate", "--campaign", "all", "--preemption_rate", "0.2",
      "--checkpoint-every-h", "0.5", "--placement", "pack"], None, None),
]


def _job_fields(job):
    d = {f.name: getattr(job, f.name) for f in dataclasses.fields(job)
         if f.name != "payload"}
    d["resources"] = dataclasses.asdict(job.resources)
    return d, job.manifest()


@pytest.mark.parametrize("argv,res,labels", ARGVS,
                         ids=lambda a: " ".join(a) if isinstance(a, list)
                         else None)
def test_argv_gives_the_same_spec(argv, res, labels, monkeypatch):
    monkeypatch.setenv("ARCH", "granite-3-2b")
    monkeypatch.setenv("SEED", "5")
    specs = []
    for pkg, R in ((J, JResources), (T, Resources)):
        spec = pkg.RunSpec.from_args(argv)
        if res:
            spec = spec.replace(resources=R(**res))
        if labels:
            spec = spec.replace(labels=labels)
        specs.append(spec)
    j, t = specs
    assert t.to_dict() == j.to_dict()
    assert t.to_json() == j.to_json()
    assert t.to_env() == j.to_env()
    env = t.to_env(full=True)
    assert env == j.to_env(full=True)
    assert T.RunSpec.from_env(env) == t
    assert J.RunSpec.from_env(env).to_dict() == t.to_dict()
    assert T.RunSpec.from_json(j.to_json()) == t
    assert (t.short_hash(), t.run_name) == (j.short_hash(), j.run_name)
    assert _job_fields(t.to_job()) == _job_fields(j.to_job())


def test_paper_grid_gives_the_same_144_specs():
    def runs(grid_fn, R, pkg):
        out = []
        for arch, grid in grid_fn().items():
            out += [r.to_dict() for r in grid.to_runs(
                kind="train", arch=arch,
                resources=R(gpus=2, cpus=4, memory_gb=24),
                duration_h=518.0 / 144, labels={"experiment": f"ba-{arch}"})]
        return out
    got = runs(paper_burned_area_grid, Resources, T)
    assert len(got) == 144
    assert got == runs(jax_paper_grid, JResources, J)
    grid = paper_burned_area_grid()["unet"]
    assert [r.to_dict() for r in T.grid_to_runs(grid)] == [
        r.to_dict() for r in J.grid_to_runs(jax_paper_grid()["unet"])]


# --------------------------------------------------------------- registry
@pytest.fixture
def toy_kinds():
    """Register a toy kind in both registries, ``make(pkg)`` giving each
    package's runner; remove them afterwards (the registries are
    process-wide)."""
    added = []

    def register(kind, make, env=None):
        for pkg, reg in ((J, jregistry), (T, tregistry)):
            reg.register_runner(kind, make(pkg), env=env)
        added.append(kind)
    yield register
    for reg in (jregistry, tregistry):
        for kind in added:
            reg._RUNNERS.pop(kind, None)
            reg._KIND_ENV.pop(kind, None)


def test_runner_exception_is_a_failed_report(toy_kinds):
    def boom(spec):
        raise RuntimeError("boom")
    toy_kinds("torch-api-boom", lambda pkg: boom)
    reports = [pkg.run(pkg.RunSpec(kind="torch-api-boom",
                                   overrides={"x": 1}))
               for pkg in (J, T)]
    for r in reports:
        assert r.status == "failed" and not r.ok
        assert r.error == "RuntimeError: boom"
        assert "Traceback" in r.metrics["traceback"]
    assert reports[0].spec == reports[1].spec
    assert reports[0].name == reports[1].name


def test_env_prerequisites_are_applied_before_the_runner(toy_kinds,
                                                         monkeypatch):
    monkeypatch.delenv("TORCH_API_TOY_FLAG", raising=False)
    seen = []

    def make(pkg):
        def fn(spec):
            seen.append(os.environ.get("TORCH_API_TOY_FLAG"))
            return pkg.RunReport(kind=spec.kind, name=spec.run_name)
        return fn
    toy_kinds("torch-api-env", make, env={"TORCH_API_TOY_FLAG": "on"})
    for pkg in (J, T):
        assert pkg.run(pkg.RunSpec(kind="torch-api-env")).ok
    assert seen == ["on", "on"]
    monkeypatch.setenv("TORCH_API_TOY_FLAG", "mine")   # setdefault only
    assert T.run(T.RunSpec(kind="torch-api-env")).ok
    assert seen[-1] == "mine"


def test_unknown_kind_and_the_five_kinds():
    for pkg in (J, T):
        with pytest.raises(KeyError, match="no runner registered"):
            pkg.get_runner("torch-api-nope")
        with pytest.raises(KeyError):
            pkg.run(pkg.RunSpec(kind="torch-api-nope"))
        assert set(FIVE) <= set(pkg.runner_kinds())
    assert sorted(tregistry._LAZY_BUILTINS) == sorted(
        jregistry._LAZY_BUILTINS) == FIVE
    assert tregistry._KIND_ENV == {}          # no XLA flag in the port


def test_typo_guard_matches_the_reference():
    """An unknown override fails the run the same way; the port accepts
    one key more, its ``device``."""
    errs = [pkg.run(pkg.RunSpec(kind=kind, overrides={"stpes": 3})).error
            for kind in ("train", "serve") for pkg in (J, T)]
    for j, t in zip(errs[::2], errs[1::2]):
        head = "ValueError: unknown overrides for kind"
        assert j.startswith(head) and t.startswith(head)
        assert j.split("; accepted")[0] == t.split("; accepted")[0]
        acc = [set(ast.literal_eval(e.split("accepted: ")[1]))
               for e in (j, t)]
        assert acc[1] - acc[0] == {"device"} and acc[0] <= acc[1]


@pytest.mark.parametrize("kind,overrides,what", [
    ("dryrun", {}, "NotImplementedError"),
    ("perfprobe", {"shape": "decode_32k"}, "NotImplementedError"),
    ("train", {"world_size": 2}, "NotImplementedError"),
    ("train", {"dist_rank": 0}, "NotImplementedError"),
    ("train", {"coordinator": "localhost:1234"}, "NotImplementedError"),
    ("train", {"attention_backend": "triton", "device": "cpu"},
     "ValueError"),
])
def test_unported_and_malformed_runs_fail(kind, overrides, what):
    r = T.run(T.RunSpec(kind=kind, overrides=overrides))
    assert r.status == "failed" and r.error.startswith(what)


def test_without_a_card_nothing_falls_back_to_the_cpu(monkeypatch,
                                                      tmp_path):
    """Without ``device``, a runner fails its report and a ``run_local``
    job fails every attempt; nothing runs on the CPU instead."""
    from repro_torch.core import Orchestrator, PersistentVolume
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind, extra in (("train", SMALL), ("serve", {"requests": 1})):
        r = T.run(T.RunSpec(kind=kind, overrides=extra))
        assert r.status == "failed" and "no CUDA device" in r.error
    orch = Orchestrator(PersistentVolume(tmp_path))
    orch.submit_runs([T.RunSpec(kind="train", name="no-card",
                                overrides=SMALL)], attach_payload=True)
    rec = orch.run_local()["no-card"]
    assert (rec.state.value, rec.attempts) == ("Failed", 4)
    assert "no CUDA device" in rec.error


def test_backend_names_map_onto_the_port():
    assert [port_backend(n) for n in
            ("jnp", "pallas", "auto", "torch", "cuda", None)] == [
        "torch", "cuda", "auto", "torch", "cuda", None]
    with pytest.raises(ValueError, match="unknown kernel backend"):
        port_backend("xla")


# ------------------------------------------------- the slice, end to end
def test_preempted_under_the_reference_resumes_under_the_port(tmp_path):
    """The reference's ``run`` trains reduced stablelm-1.6b (SGD, f32)
    and is preempted before step 4; the port's ``run`` resumes the same
    spec from its checkpoint directory on the CPU.  Losses of steps 4-5
    equal the reference's uninterrupted run's (rtol 1e-5)."""
    base = {"optimizer": "sgd", "steps": 6, "batch": 2, "seq": 16,
            "log_every": 0, "checkpoint_every": 2,
            "checkpoint_async": False}
    ck = str(tmp_path / "ck")
    spec = J.RunSpec(kind="train", overrides={
        **base, "checkpoint_dir": ck, "preempt_at_step": 4})
    pre = J.run(spec)
    assert pre.status == "failed" and pre.error.startswith("Preemption")
    oracle = J.run(J.RunSpec(kind="train", overrides=base))
    assert oracle.ok and len(oracle.metrics["losses"]) == 6

    port_spec = T.RunSpec.from_dict(spec.to_dict())
    port_spec = port_spec.replace(overrides={
        **port_spec.overrides, "resume": True, "device": "cpu"})
    res = T.run(port_spec)
    assert res.ok, res.error
    assert res.metrics["resumed_from_step"] == 4
    assert res.metrics["device"] == "cpu"
    np.testing.assert_allclose(res.metrics["losses"],
                               oracle.metrics["losses"][4:], rtol=1e-5)
    assert res.artifacts == (ck,)


def test_runners_equal_direct_calls():
    spec = T.RunSpec(kind="train", overrides={**SMALL, "device": "cpu"})
    report = T.run(spec)
    direct = train_main("stablelm-1.6b", steps=3, batch=2, seq=16,
                        log_every=0, device="cpu")
    assert report.ok and report.metrics["losses"] == direct["losses"]
    assert report.spec == spec.to_dict() and report.wall_s > 0

    kw = {"requests": 3, "max_tokens": 4}
    for arch in ("granite-3-2b", "mamba2-2.7b"):
        r = T.run(T.RunSpec(kind="serve", arch=arch,
                            overrides={**kw, "device": "cpu"}))
        d = serve_main(arch, device="cpu", **kw)
        assert r.ok
        for key in ("tokens", "requests", "decode_steps", "prefill_calls",
                    "flash_attention_launches", "ssd_scan_launches"):
            assert r.metrics[key] == d[key], key


def test_the_launch_main_in_process(capsys):
    assert launch_main(["help"]) == 0
    assert "usage: python -m repro_torch.launch" in capsys.readouterr().out
    assert launch_main(["run"]) == 2
    assert launch_main(["frobnicate"]) == 2
    assert launch_main(["run", "train", "stray"]) == 2
    capsys.readouterr()
    assert launch_main(["run", "dryrun"]) == 1
    assert json.loads(capsys.readouterr().out)["status"] == "failed"


def _cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_kinds_bogus_and_campaign_exit_codes():
    kinds = _cli("kinds")
    assert kinds.returncode == 0 and kinds.stdout.split() == FIVE
    bogus = _cli("run", "bogus")
    assert bogus.returncode == 2 and "bogus" in bogus.stderr
    assert bogus.stdout == ""
    for args in (("campaign", "run", "--jobs", "x.json"),
                 ("campaign", "status")):
        proc = _cli(*args)
        assert proc.returncode == 2 and "not ported" in proc.stderr


def test_cli_run_train_on_the_cpu():
    proc = _cli("run", "train", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "16", "--log_every", "0",
                "--attention-backend", "jnp")
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout[proc.stdout.index("{\n"):])
    direct = train_main("stablelm-1.6b", steps=2, batch=2, seq=16,
                        log_every=0, device="cpu")
    assert report["status"] == "succeeded"
    assert report["metrics"]["losses"] == direct["losses"]
    assert report["spec"]["overrides"]["attention_backend"] == "jnp"

"""The ``pod`` axis live: one gang of 8 CPU processes (gloo, one thread a
rank) of ``torch_pod_worker.py`` on ``{pod: 2, data: 2, model: 2}``,
started once for all its jobs, beside the reference on a host mesh of 8
CPU devices of the same shape (``jax_pod_step.py gang``).  The reduced
f32 configs on the reference's weights (the SSD decays slowed), the
global batch over ``(pod, data)``:

* ``fsdp_tp`` and ``fsdp_sp`` training of stablelm and mamba2, and
  ``fsdp_tp`` training of llama4 cut to 3 query heads and one kv head
  (a model extent of 2 does not divide them: the attention runs whole on
  every rank), two steps each: the first step's loss and ``grad_norm``
  against the port's world 1 on the same weights and batch and against
  the reference's step on the same mesh (under ``fsdp_tp``, on the same
  8 devices with the pods folded into the data axis: the reference's own
  ``fsdp_tp`` step on the three-axis host mesh strays from its world 1,
  ROADMAP Queue 3), the second step's against world 1's
  (``tp_gang_common``'s tolerances); the two pods' parameters equal bit
  for bit after each step; each rank's ``pod_gradsync`` bytes the count
  from the shapes, run over its pod group of 2; the ``fsdp2`` gathers
  over the 4 ranks of its pod; llama4's ``tp_allreduce`` and
  ``tp_weights`` bytes the shape counts;
* ``fsdp_sp`` prefill and 4 decode steps of granite: every step's logits
  and the decode state's blocks against world 1 and against the
  reference's prefill and ``build_decode`` steps on the same mesh;
* every job: the rank traced on ``meta`` as that rank of the grid counts
  the same bytes by mechanism as the live rank, to the byte;
* and ``run perfprobe --world_size 4 --pod 2`` runs its gang on ``{pod:
  2, data: 2}``.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.data.inputs import make_batch  # noqa: E402
from repro_torch.core.executor import parse_trailing_report  # noqa: E402
from repro_torch.distributed import free_port  # noqa: E402
from repro_torch.launch.perfprobe import probe  # noqa: E402
from repro_torch.launch.steps import (build_train,  # noqa: E402
                                      pick_optimizer, shard_ctx_for)
from repro_torch.sharding import use_ctx  # noqa: E402
from repro_torch.train.step import TrainState  # noqa: E402

from torch_one_thread import one_thread  # noqa: E402,F401
import sp_gang_common as C  # noqa: E402
import torch_pod_worker as W  # noqa: E402
import torch_sp_worker as SW  # noqa: E402
import tp_gang_common as TC  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TRAIN = [j for j in W.JOBS if j.kind == "train"]
SERVE = [j for j in W.JOBS if j.kind == "serve"]
# the gang and the reference side by side, each job under a limit of its
# own in the worker
GANG_SECONDS = 400


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("pod_gang")
    for arch in {j.arch for j in W.JOBS}:
        np.savez(work / f"{arch}.params.npz", **SW.slow_decay(_flatten(
            JM.init_params(jax.random.PRNGKey(TC.KEY),
                           W.config(arch, jax_reduced)))))
    for job in W.JOBS:
        np.savez(work / f"{job.tag}.batch.npz",
                 **{k: v.numpy() for k, v in make_batch(
                     W.config(job.arch, get_reduced), W.B, W.S, W.SEED,
                     device="cpu").items()})
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_pod_worker.py"),
         str(r), str(W.WORLD), coordinator, str(work)], env=TC._env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(W.WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_pod_step.py"), "gang",
         str(work), str(TC.KEY)],
        env=TC._env(XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=GANG_SECONDS)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * len(procs), outs
    return work


def _load(work, rank, job):
    name = f"rank{rank}.{job.tag}"
    return (dict(np.load(work / f"{name}.npz")),
            json.loads((work / f"{name}.json").read_text()))


def _world1_train(work, job) -> list:
    """The port's world-1 steps on the same weights and global batch,
    under the mesh's ctx (whose batch groups are the gang's MoE dispatch
    groups: each rank's rows)."""
    cfg = W.config(job.arch, get_reduced)
    fn, (_, batch) = build_train(cfg, W.B, W.S, device="cpu", seed=W.SEED)
    params = params_from_flat(dict(np.load(work / f"{job.arch}.params.npz")),
                              cfg, device="cpu")
    state = TrainState(params, pick_optimizer(cfg).init(params), 0)
    out = []
    with use_ctx(shard_ctx_for(W.MESH, job.layout)):
        for _ in range(2):
            state, metrics = fn(state, batch)
            out.append({k: float(metrics[k]) for k in ("loss",
                                                       "grad_norm")})
    return out


@pytest.mark.parametrize("job", TRAIN, ids=[j.tag for j in TRAIN])
def test_training_matches_world1_and_the_reference(gang, job):
    want = _world1_train(gang, job)
    ref = json.loads((gang / f"ref.{job.tag}.json").read_text())
    # the reference's fsdp_tp step on the three-axis host mesh strays from
    # its own world 1 and from the same 8 devices with the pods folded
    # into data (a fault of the reference's lowering on the CPU, ROADMAP
    # Queue 3): the port is held against the folded mesh there
    held = ref["folded"] if job.layout == "fsdp_tp" else ref
    for rank in range(W.WORLD):
        _, info = _load(gang, rank, job)
        assert info["rows"] == 1
        for got, one in zip(info["steps"], want):
            np.testing.assert_allclose(got["loss"], one["loss"],
                                       rtol=TC.LOSS_RTOL)
            TC.close(got["grad_norm"], one["grad_norm"],
                     f"{job.tag} grad_norm")
        first = info["steps"][0]
        np.testing.assert_allclose(first["loss"], held["loss"],
                                   rtol=TC.LOSS_RTOL)
        TC.close(first["grad_norm"], held["grad_norm"],
                 f"{job.tag} reference grad_norm")


@pytest.mark.parametrize("job", TRAIN, ids=[j.tag for j in TRAIN])
def test_pods_hold_equal_parameters(gang, job):
    """After each step, rank ``r`` of pod 0 and rank ``r + 4`` of pod 1
    gather the same parameters, bit for bit."""
    for rank in range(4):
        a, _ = _load(gang, rank, job)
        b, _ = _load(gang, rank + 4, job)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("job", TRAIN, ids=[j.tag for j in TRAIN])
def test_pod_gradsync_and_the_groups(gang, job):
    """``pod_gradsync`` is the count from the shapes and runs over 2
    ranks; the ``fsdp2`` gathers run over the 4 ranks of the pod; under
    ``fsdp_tp`` ``tp_allreduce`` is its shape count, and llama4's whole
    attention gathers ``tp_weights`` by its own."""
    for rank in range(W.WORLD):
        _, info = _load(gang, rank, job)
        got = info["bytes"]
        assert got["pod_gradsync"] == info["pod_gradsync_shape"] > 0
        assert info["groups"]["pod_gradsync"] == [2]
        if job.layout == "fsdp_sp":
            assert 4 in info["groups"]["fsdp_allgather"]
        else:
            assert got["tp_allreduce"] == info["tp_allreduce_shape"]
        if job.arch in W.HEADS:
            assert got["tp_weights"] == info["tp_weights_shape"] > 0


@pytest.mark.parametrize("job", TRAIN, ids=[j.tag for j in TRAIN])
def test_meta_rank_counts_the_live_bytes(gang, job):
    for rank in range(W.WORLD):
        _, info = _load(gang, rank, job)
        assert info["meta_bytes"] == info["bytes"]
        assert info["meta_groups"] == info["groups"]


@pytest.mark.parametrize("job", SERVE, ids=[j.tag for j in SERVE])
def test_prefill_and_decode_match_world1_and_the_reference(gang, job):
    want = _world1_serve(gang, job)
    ref = dict(np.load(gang / f"ref.{job.tag}.npz"))
    for rank in range(W.WORLD):
        got, info = _load(gang, rank, job)
        block = 2 * (rank // 4) + rank // 2 % 2
        rows = slice(block, block + 1)
        for name, whole in (("world 1", want), ("reference", ref)):
            TC.close(got["logits"], whole["logits"][:, rows],
                     f"{job.tag} logits against {name}")
            for k in ("k", "v"):
                TC.close(got[f"state/{k}"],
                         C.block_of(whole[f"state/{k}"][:, rows], k,
                                    rank % 2, 2),
                         f"{job.tag} state {k} against {name}")
        assert info["meta_prefill_bytes"] == info["prefill_bytes"]
        for step in info["decode_bytes"]:
            assert info["meta_decode_bytes"] == step


def _world1_serve(work, job) -> dict:
    """The port's world-1 prefill and decode steps of the global batch,
    in the layout of ``jax_pod_step``'s arrays."""
    run = job.run
    # sp_gang_common reads a run's batch under the run's own tag
    src = work / f"{run.tag}.batch.npz"
    if not src.exists():
        src.write_bytes((work / f"{job.tag}.batch.npz").read_bytes())
    got = C.world1_run(work, run)
    return {"logits": got["logits"],
            **{f"state/{k}": v for k, v in got["state"].items()}}


def test_the_pod_probe(tmp_path):
    """``run perfprobe --world_size 4 --pod 2`` (``fsdp_tp``, reduced
    stablelm): the gang's ranks on ``{pod: 2, data: 2}``, its losses
    world 1's, each rank's ``pod_gradsync`` the count from the shapes,
    the record's analytic bytes for the same grid."""
    src = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "run", "perfprobe",
         "--arch", "stablelm-1.6b", "--shape", "train_4k", "--layout",
         "fsdp_tp", "--world_size=4", "--pod=2", "--device=cpu",
         "--reduced=true", "--batch=4", "--seq=32"], cwd=tmp_path,
        capture_output=True, text=True, timeout=240,
        env={**TC._env(), "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    met = parse_trailing_report(proc.stdout)["metrics"]
    one = probe("stablelm-1.6b", "train_4k", "fsdp_tp", device="cpu",
                reduced=True, batch=4, seq=32)
    np.testing.assert_allclose(met["losses"], one["losses"], rtol=1e-5)
    assert met["mesh"] == "pod 2 x data 2 x model 1 (one host)"
    assert met["analytic_collective_bytes"]["pod_gradsync"] > 0
    for d in met["gang"]["ranks"]:
        assert d["grid"] == {"pod": 2, "data": 2}
        assert d["collective_bytes"]["pod_gradsync"] == d[
            "pod_gradsync_shape_bytes"] > 0

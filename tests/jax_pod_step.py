"""The reference on host meshes with a ``pod`` axis, CPU devices standing in
for chips (one process for every case a test module needs):

* ``memory``: ``repro.launch.steps.build_train(cfg, mesh, layout, B, S)``
  for reduced stablelm under ``fsdp_tp`` and ``fsdp_sp`` on each mesh of
  :data:`MEMORY_MESHES`, lowered and compiled; writes
  ``ref.memory.json``, each case's ``memory_analysis()
  .argument_size_in_bytes`` (one device's arguments: its shards of the
  state and its rows of the batch);
* ``gang``: for each train job of ``torch_pod_worker.JOBS``, the
  reference's train step on ``torch_pod_worker.MESH`` from the weights
  ``jax.random.PRNGKey(KEY)`` draws (``jax_sp_step._params``: the SSD
  decays slowed) and the job's batch in ``WORKDIR`` (``ref.<tag>.json``:
  its loss and ``grad_norm``, both before its update; under ``fsdp_tp``
  also the step on ``torch_pod_worker.FOLDED``, the pods folded into the
  data axis, under ``"folded"``); for each serve job, the
  reference's prefill and ``build_decode`` steps
  (``jax_sp_step.serve``: ``ref.<tag>.npz``).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/jax_pod_step.py memory|gang WORKDIR [KEY]
"""
import json
import math
import sys
from pathlib import Path

import jax
import numpy as np

from repro.configs import get_reduced
from repro.launch.steps import build_train, pick_optimizer
from repro.sharding.ctx import use_ctx
from repro.train.step import TrainState

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jax_sp_step  # noqa: E402
import torch_pod_worker as W  # noqa: E402

MEMORY_MESHES = ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2})
MEMORY_B, MEMORY_S = 8, 64


def _mesh(dims: dict):
    n = math.prod(dims.values())
    # Auto axes: with_sharding_constraint refuses Explicit ones
    return jax.sharding.Mesh(
        np.array(jax.devices()[:n]).reshape(tuple(dims.values())),
        tuple(dims))


def memory(work: Path) -> None:
    cfg = W.config("stablelm-1.6b", get_reduced)
    out = {}
    for dims in MEMORY_MESHES:
        for layout in ("fsdp_tp", "fsdp_sp"):
            mesh = _mesh(dims)
            jitted, args, ctx = build_train(cfg, mesh, layout, MEMORY_B,
                                            MEMORY_S)
            with use_ctx(ctx):
                compiled = jitted.lower(*args).compile()
            out[W.mesh_tag(dims) + "." + layout] = (
                compiled.memory_analysis().argument_size_in_bytes)
    (work / "ref.memory.json").write_text(json.dumps(out))


def _step(cfg, key: int, batch, dims: dict, layout: str) -> dict:
    params = jax_sp_step._params(cfg, key)
    opt = pick_optimizer(cfg)
    state = TrainState(params, opt.init(params), jax.numpy.int32(0))
    jitted, _, ctx = build_train(cfg, _mesh(dims), layout, W.B, W.S)
    with use_ctx(ctx):
        _, metrics = jitted(state, batch)
    return {k: float(metrics[k]) for k in ("loss", "grad_norm")}


def train(job, work: Path, key: int) -> None:
    """The step on ``W.MESH``; under ``fsdp_tp`` also on ``W.FOLDED``
    (the pods folded into the data axis, the same 8 devices)."""
    cfg = W.config(job.arch, get_reduced)
    batch = dict(np.load(work / f"{job.tag}.batch.npz"))
    out = _step(cfg, key, batch, W.MESH, job.layout)
    if job.layout == "fsdp_tp":
        out["folded"] = _step(cfg, key, batch, W.FOLDED, job.layout)
    (work / f"ref.{job.tag}.json").write_text(json.dumps(out))


def main(mode: str, work: Path, key: int) -> None:
    if mode == "memory":
        memory(work)
        return
    for job in W.JOBS:
        if job.kind == "train":
            train(job, work, key)
        else:
            cfg = W.config(job.arch, get_reduced)
            jax_sp_step.serve(cfg, _mesh(W.MESH),
                              jax_sp_step._params(cfg, key),
                              dict(np.load(work / f"{job.tag}.batch.npz")),
                              job.run, work / f"ref.{job.tag}.npz")


if __name__ == "__main__":
    main(sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]) if sys.argv[3:]
         else 0)

"""The reference's ``fsdp_tp`` steps on a host mesh of CPU devices with
a ``model`` axis, from the weights ``jax.random.PRNGKey(KEY)`` draws for
each reduced config and the tokens in ``WORKDIR``; ``PART`` is ``train``
or ``serve`` (two processes, run side by side):

* (``train``) ``repro.launch.steps.build_train(cfg, mesh, "fsdp_tp",
  B, S)`` for each case of ``torch_tp_worker.REF[CASES]``, its mesh the case's
  ``{data, model}`` grid over the first devices: writes
  ``ref.<tag>.json`` with its loss and ``grad_norm`` (both taken before
  its update);
* (``serve``) ``build_prefill`` and ``build_decode(cfg, mesh,
  "fsdp_tp", B, cache)`` for each serving case of ``torch_tp_worker.REF_SERVE[CASES]``
  (its cache ``cache`` slots): the prefill of the case's tokens and
  ``DECODE`` greedy steps, each step's token its own argmax; writes
  ``ref.<tag>.serve.npz`` with every step's logits.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_tp_step.py CASES WORKDIR KEY PART
"""
import json
import math
import sys
from pathlib import Path

import jax
import numpy as np

from repro.configs import get_reduced
from repro.launch.steps import (build_decode, build_prefill, build_train,
                                pick_optimizer)
from repro.models import model as JM
from repro.sharding import rules
from repro.sharding.ctx import use_ctx
from repro.train.step import TrainState

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_tp_worker as W  # noqa: E402


def main(cases: str, work: Path, key: int, part: str) -> None:
    if part == "serve":
        for case in W.REF_SERVE[cases]:
            serve(work, case, key)
        return
    for arch, grid, _ in W.REF[cases]:
        dims = {"data": grid.get("data", 1), "model": grid["model"]}
        n = math.prod(dims.values())
        # Auto axes: with_sharding_constraint refuses Explicit ones
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(tuple(dims.values())),
            tuple(dims))
        cfg = get_reduced(arch)
        params = JM.init_params(jax.random.PRNGKey(key), cfg)
        opt = pick_optimizer(cfg)
        state = TrainState(params, opt.init(params), jax.numpy.int32(0))
        batch = {"tokens": np.load(work / f"{arch}.tokens.npy")}
        jitted, _, ctx = build_train(cfg, mesh, "fsdp_tp", W.B, W.S)
        with use_ctx(ctx):
            _, metrics = jitted(state, batch)
        (work / f"ref.{W.tag(arch, grid)}.json").write_text(json.dumps(
            {k: float(metrics[k]) for k in ("loss", "grad_norm")}))


def _mesh(grid: dict):
    dims = {"data": grid.get("data", 1), "model": grid["model"]}
    n = math.prod(dims.values())
    # Auto axes: with_sharding_constraint refuses Explicit ones
    return jax.sharding.Mesh(
        np.array(jax.devices()[:n]).reshape(tuple(dims.values())),
        tuple(dims))


def serve(work: Path, case, key: int) -> None:
    """The reference's sharded prefill and decode steps of one case."""
    mesh = _mesh(case.mesh)
    cfg = W.config(get_reduced, case.arch, case.heads)
    params = JM.init_params(jax.random.PRNGKey(key), cfg)
    tokens = np.load(work / f"{case.name}.tokens.npy")
    pre, _, ctx = build_prefill(cfg, mesh, "fsdp_tp", W.B, case.cache)
    dec, _, _ = build_decode(cfg, mesh, "fsdp_tp", W.B, case.cache)
    with use_ctx(ctx):
        logits, state = pre(params, {"tokens": tokens})
        # the prefill's state as the decode step takes it: the rules'
        # blocks (the cache's slots over model)
        state = jax.device_put(state, rules.decode_state_shardings(
            state, mesh, "fsdp_tp"))
        steps = [np.asarray(logits)]
        for i in range(W.DECODE):
            tok = np.asarray(jax.numpy.argmax(logits, -1),
                             np.int32)[:, None]
            pos = np.full((W.B,), W.S + i, np.int32)
            logits, state = dec(params, state, tok, pos)
            steps.append(np.asarray(logits))
    np.savez(work / f"ref.{W.tag(case.name, case.mesh)}.serve.npz",
             logits=np.stack(steps))


if __name__ == "__main__":
    main(sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

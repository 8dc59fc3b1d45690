"""The reference's ``fsdp_tp`` train step on a host mesh of CPU devices
with a ``model`` axis: ``repro.launch.steps.build_train(cfg, mesh,
"fsdp_tp", B, S)`` for each case of ``torch_tp_worker.REF[CASES]``,
its mesh the case's ``{data, model}`` grid over the first devices, from
the weights ``jax.random.PRNGKey(KEY)`` draws for the reduced config and
the tokens in ``WORKDIR``.  Writes ``ref.<tag>.json`` with its loss and
``grad_norm`` (both taken before its update).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_tp_step.py CASES WORKDIR KEY
"""
import json
import math
import sys
from pathlib import Path

import jax
import numpy as np

from repro.configs import get_reduced
from repro.launch.steps import build_train, pick_optimizer
from repro.models import model as JM
from repro.sharding.ctx import use_ctx
from repro.train.step import TrainState

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_tp_worker as W  # noqa: E402


def main(cases: str, work: Path, key: int) -> None:
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


if __name__ == "__main__":
    main(sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]))

"""The reference's ``fsdp_sp`` train step on a host mesh of CPU devices
with a ``model`` axis: ``repro.launch.steps.build_train(cfg, mesh,
"fsdp_sp", B, S)`` for each case of ``torch_sp_worker.REF[CASES]``, its
mesh the case's ``{data, model}`` grid over the first devices, from the
weights ``jax.random.PRNGKey(KEY)`` draws for the reduced config (the
SSD layers' ``A_log`` set as ``torch_sp_worker.slow_decay`` sets it) and
the batch in ``WORKDIR``.  Writes ``ref.<tag>.json`` with its loss and
``grad_norm`` (both taken before its update).

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        python tests/jax_sp_step.py CASES WORKDIR KEY
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
import torch_sp_worker as W  # noqa: E402


def main(cases: str, work: Path, key: int) -> None:
    for arch, grid, _ in W.REF[cases]:
        n = math.prod(grid.values())
        # Auto axes: with_sharding_constraint refuses Explicit ones
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(tuple(grid.values())),
            tuple(grid))
        cfg = get_reduced(arch)
        params = JM.init_params(jax.random.PRNGKey(key), cfg)
        for slot in params["periods"].values():
            if "ssm" in slot:
                slot["ssm"]["A_log"] = jax.numpy.asarray(W.slow_decay(
                    {"ssm/A_log": np.asarray(slot["ssm"]["A_log"])}
                )["ssm/A_log"])
        opt = pick_optimizer(cfg)
        state = TrainState(params, opt.init(params), jax.numpy.int32(0))
        batch = dict(np.load(work / f"{arch}.batch.npz"))
        jitted, _, ctx = build_train(cfg, mesh, "fsdp_sp", W.B, W.S)
        with use_ctx(ctx):
            _, metrics = jitted(state, batch)
        (work / f"ref.{W.tag(arch, grid)}.json").write_text(json.dumps(
            {k: float(metrics[k]) for k in ("loss", "grad_norm")}))


if __name__ == "__main__":
    main(sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]))

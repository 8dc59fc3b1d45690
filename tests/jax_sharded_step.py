"""The reference's sharded train step on a host mesh of two CPU devices:
``repro.launch.steps.build_train(cfg, mesh{data: 2}, layout, B, S)`` for
each case of ``torch_sharding_worker.CASES``, from the weights
``jax.random.PRNGKey(KEY)`` draws for the reduced config and the tokens
in ``WORKDIR``.  Writes ``ref.<arch>.<layout>.json`` with its loss and
``grad_norm`` (both taken before its update).

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        python tests/jax_sharded_step.py WORKDIR KEY
"""
import json
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
import torch_sharding_worker as W  # noqa: E402


def main(work: Path, key: int) -> None:
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    for arch, layout in W.CASES:
        cfg = get_reduced(arch)
        params = JM.init_params(jax.random.PRNGKey(key), cfg)
        opt = pick_optimizer(cfg)
        state = TrainState(params, opt.init(params), jax.numpy.int32(0))
        batch = {"tokens": np.load(work / f"{arch}.tokens.npy")}
        jitted, _, ctx = build_train(cfg, mesh, layout, W.B, W.S)
        with use_ctx(ctx):
            _, metrics = jitted(state, batch)
        (work / f"ref.{arch}.{layout}.json").write_text(json.dumps(
            {k: float(metrics[k]) for k in ("loss", "grad_norm")}))


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]))

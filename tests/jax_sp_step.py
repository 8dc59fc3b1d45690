"""The reference's ``fsdp_sp`` steps on a host mesh of CPU devices with a
``model`` axis, from the weights ``jax.random.PRNGKey(KEY)`` draws for
the reduced config (the SSD layers' ``A_log`` set as
``torch_sp_worker.slow_decay`` sets it) and the batch in ``WORKDIR``,
each case's mesh its ``{data, model}`` grid over the first devices:

* for each case of ``torch_sp_worker.REF[CASES]``,
  ``repro.launch.steps.build_train(cfg, mesh, "fsdp_sp", B, S)``: writes
  ``ref.<tag>.json`` with its loss and ``grad_norm`` (both taken before
  its update);
* for each run of ``torch_sp_worker.RUNS[CASES]``, the same train step
  where the run trains (``ref.<run tag>.json``), then the reference's
  prefill of the run's batch into a cache of ``run.cache`` slots, jitted
  with the rules' parameter and batch shardings under the mesh's ctx,
  and ``build_decode(cfg, mesh, "fsdp_sp", B, run.cache)``'s step fed
  ``torch_sp_worker.decode_tokens``: ``ref.<run tag>.npz`` with every
  step's logits (the prefill's first) and the decode state after the
  last step, in the port's layout (each kind's layers stacked in layer
  order).

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
from repro.launch.steps import (_batch_shardings, build_decode, build_train,
                                pick_optimizer, shard_ctx_for)
from repro.models import model as JM
from repro.sharding import rules
from repro.sharding.ctx import use_ctx
from repro.train.step import TrainState

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sp_worker as W  # noqa: E402


def _mesh(grid: dict):
    n = math.prod(grid.values())
    # Auto axes: with_sharding_constraint refuses Explicit ones
    return jax.sharding.Mesh(
        np.array(jax.devices()[:n]).reshape(tuple(grid.values())),
        tuple(grid))


def _params(cfg, key: int):
    params = JM.init_params(jax.random.PRNGKey(key), cfg)
    for slot in params["periods"].values():
        if "ssm" in slot:
            slot["ssm"]["A_log"] = jax.numpy.asarray(W.slow_decay(
                {"ssm/A_log": np.asarray(slot["ssm"]["A_log"])}
            )["ssm/A_log"])
    return params


def train(cfg, mesh, params, batch, seq: int, out: Path) -> None:
    opt = pick_optimizer(cfg)
    state = TrainState(params, opt.init(params), jax.numpy.int32(0))
    jitted, _, ctx = build_train(cfg, mesh, "fsdp_sp", W.B, seq)
    with use_ctx(ctx):
        _, metrics = jitted(state, batch)
    out.write_text(json.dumps(
        {k: float(metrics[k]) for k in ("loss", "grad_norm")}))


def _port_layout(state, cfg) -> dict:
    """The decode state (per slot, stacked over periods) with each
    kind's layers stacked in layer order."""
    plan = JM._slot_plan(cfg)
    out = {}
    for layer in range(cfg.n_layers):
        p, j = divmod(layer, len(plan))
        for name, t in state[f"slot{j}"].items():
            out.setdefault(name, []).append(np.asarray(t[p]))
    return {name: np.stack(ts) for name, ts in out.items()}


def serve(cfg, mesh, params, batch, run, out: Path) -> None:
    ctx = shard_ctx_for(mesh, "fsdp_sp")
    p_sh = rules.param_shardings(JM.param_specs(cfg), mesh, "fsdp_sp")
    b_sh = _batch_shardings(mesh, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                   for k, v in batch.items()})
    pre = jax.jit(lambda p, b: JM.prefill(p, cfg, b, cache_len=run.cache),
                  in_shardings=(p_sh, b_sh))
    step, _, _ = build_decode(cfg, mesh, "fsdp_sp", W.B, run.cache)
    with use_ctx(ctx):
        logits, state = pre(params, batch)
        steps = [np.asarray(logits)]
        state = jax.device_put(state, rules.decode_state_shardings(
            state, mesh, "fsdp_sp"))
        params = jax.device_put(params, p_sh)
        for i, tok in enumerate(W.decode_tokens(run.arch, run.decode)):
            pos = np.full((W.B,), run.seq + i, dtype=np.int32)
            logits, state = step(params, state, tok, pos)
            steps.append(np.asarray(logits))
    np.savez(out, logits=np.stack(steps),
             **{f"state/{k}": v for k, v in _port_layout(state,
                                                          cfg).items()})


def main(cases: str, work: Path, key: int) -> None:
    for arch, grid, _ in W.REF.get(cases, ()):
        cfg = get_reduced(arch)
        batch = dict(np.load(work / f"{arch}.batch.npz"))
        train(cfg, _mesh(grid), _params(cfg, key), batch, W.S,
              work / f"ref.{W.tag(arch, grid)}.json")
    for run in W.RUNS.get(cases, ()):
        cfg = get_reduced(run.arch)
        mesh = _mesh(run.mesh)
        batch = dict(np.load(work / f"{run.tag}.batch.npz"))
        if run.train:
            train(cfg, mesh, _params(cfg, key), batch, run.seq,
                  work / f"ref.{run.tag}.json")
        serve(cfg, mesh, _params(cfg, key), batch, run,
              work / f"ref.{run.tag}.npz")


if __name__ == "__main__":
    main(sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]))

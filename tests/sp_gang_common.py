"""Helpers of the sequence-parallel gang tests (``test_torch_sp_*.py``):
the reference's weights and a global batch written once, a gang of
``torch_sp_worker.py`` ranks and the reference's ``fsdp_sp`` steps
(``jax_sp_step.py``) started together, and the port's world-1 results on
the same weights and batch to hold the gang against (:func:`world1`;
a serving run's :func:`world1_run`)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax

from repro.checkpoint.io import _flatten
from repro.configs import get_reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_flat, params_to_flat
from repro_torch.data.inputs import make_batch
from repro_torch.distributed import free_port
from repro_torch.launch.steps import shard_ctx_for
from repro_torch.models.model import (decode_step, forward, period_len,
                                      prefill)
from repro_torch.optim import get_optimizer
from repro_torch.sharding import use_ctx
from repro_torch.sharding.tp import STATE_DIM
from repro_torch.train import make_loss_and_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.tree import tree_unflatten

import torch_sp_worker as W
from tp_gang_common import KEY, _env

ROOT = Path(__file__).resolve().parent.parent
# what the FSDP storage itself moves, beside sp_bytes' mechanisms
FSDP_MECHANISMS = {"fsdp_allgather", "grad_reducescatter",
                   "replicated_allreduce", "norm_allreduce"}


def start(work: Path, cases: str, world: int, ref_devices: int = 0) -> None:
    """Write the weights and the batch of every arch (a serving list's:
    every run) of ``cases``, run the gang of ``world`` ranks and, with
    ``ref_devices``, the reference's sharded steps on a host mesh of
    that many CPU devices side by side, and raise unless all exit 0."""
    batches = ({r.tag: (r.arch, r.seq) for r in W.RUNS[cases]}
               if cases in W.RUNS else
               {a: (a, W.S) for a, _, _ in W.CASES[cases]})
    for arch in {a for a, _ in batches.values()}:
        np.savez(work / f"{arch}.params.npz",
                 **W.slow_decay(_flatten(JM.init_params(
                     jax.random.PRNGKey(KEY), jax_reduced(arch)))))
    for name, (arch, seq) in batches.items():
        np.savez(work / f"{name}.batch.npz",
                 **{k: v.numpy() for k, v in make_batch(
                     get_reduced(arch), W.B, seq, 5, device="cpu").items()})
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sp_worker.py"), cases,
         str(r), str(world), coordinator, str(work)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    if ref_devices:
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "jax_sp_step.py"), cases,
             str(work), str(KEY)],
            env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count="
                               f"{ref_devices}"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=400)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), outs


def world1(work: Path, arch: str, serve: bool) -> dict:
    """The port's world-1 loss, gradients, steps and (``serve``) prefill
    on the global batch."""
    cfg = get_reduced(arch)
    flat = dict(np.load(work / f"{arch}.params.npz"))
    batch = W.global_batch(work, arch)
    params = params_from_flat(flat, cfg, device="cpu")
    loss, grads = make_loss_and_grads(cfg, loss_chunk=W.CHUNK)(params,
                                                               batch)
    out = {"loss": float(loss), "grad_leaves": grads,
           "grad": params_to_flat(tree_unflatten(params, grads),
                                  period_len(cfg))}
    for name in (cfg.optimizer, "lamb"):
        opt = get_optimizer(name)
        step = make_train_step(cfg, opt, lr_schedule=lambda s: W.LR,
                               loss_chunk=W.CHUNK)
        p = params_from_flat(flat, cfg, device="cpu")
        _, metrics = step(TrainState(p, opt.init(p), 0), batch)
        out[name] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
    if serve:
        if cfg.is_encoder_only:
            with torch.no_grad():
                out["logits"] = forward(params, cfg, batch,
                                        remat=False)[:, -1, :]
            out["prefill_state"] = {}
        else:
            out["logits"], out["prefill_state"] = prefill(
                params, cfg, batch, cache_len=W.S)
    return out


def world1_run(work: Path, run) -> dict:
    """The port's world-1 numbers of a :class:`torch_sp_worker.Run` on the
    global batch, under the mesh's ``fsdp_sp`` ctx (whose ``seq`` groups
    are the gang's MoE dispatch groups): the loss, gradients and the arch
    optimizer's step where it trains; the prefill's and each decode
    step's logits and the decode state after the last."""
    cfg = get_reduced(run.arch)
    flat = dict(np.load(work / f"{run.arch}.params.npz"))
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(work / f"{run.tag}.batch.npz").items()}
    out = {}
    with use_ctx(shard_ctx_for(run.mesh, "fsdp_sp")):
        params = params_from_flat(flat, cfg, device="cpu")
        if run.train:
            loss, grads = make_loss_and_grads(cfg, loss_chunk=W.CHUNK)(
                params, batch)
            out["loss"] = float(loss)
            out["grad"] = params_to_flat(tree_unflatten(params, grads),
                                         period_len(cfg))
            opt = get_optimizer(cfg.optimizer)
            step = make_train_step(cfg, opt, lr_schedule=lambda s: W.LR,
                                   loss_chunk=W.CHUNK)
            p = params_from_flat(flat, cfg, device="cpu")
            _, metrics = step(TrainState(p, opt.init(p), 0), batch)
            out["step"] = {k: float(metrics[k]) for k in ("loss",
                                                          "grad_norm")}
        logits, state = prefill(params, cfg, batch, cache_len=run.cache)
        steps = [logits]
        for i, tok in enumerate(W.decode_tokens(run.arch, run.decode)):
            pos = torch.full((W.B,), run.seq + i, dtype=torch.int32)
            logits, state = decode_step(params, cfg, state,
                                        torch.from_numpy(tok), pos)
            steps.append(logits)
    out["logits"] = torch.stack(steps).numpy()
    out["state"] = {k: v.numpy() for k, v in state.items()}
    return out


def load_run(work: Path, rank: int, run):
    """Rank ``rank``'s arrays and record of a serving run."""
    name = f"rank{rank}.{run.tag}"
    return (dict(np.load(work / f"{name}.npz")),
            json.loads((work / f"{name}.json").read_text()))


def block_of(t: np.ndarray, name: str, rank: int, M: int) -> np.ndarray:
    """Rank ``rank``'s block of a stacked decode-state leaf as the rules
    split it (``ModelAxis.state_block``'s, a layer dim ahead)."""
    d = STATE_DIM[name] + 1
    n = t.shape[d]
    if n % M:
        return t
    return np.take(t, range(rank * n // M, (rank + 1) * n // M), axis=d)


def load(work: Path, rank: int, arch: str, mesh: dict):
    """Rank ``rank``'s arrays and record of a case."""
    name = f"rank{rank}.{W.tag(arch, mesh)}"
    return (dict(np.load(work / f"{name}.npz")),
            json.loads((work / f"{name}.json").read_text()))


def update(work: Path, arch: str, name: str, grads_flat) -> dict:
    """World 1's update of the weights by ``grads_flat`` (the gang's
    gradients, gathered)."""
    cfg = get_reduced(arch)
    p = params_from_flat(dict(np.load(work / f"{arch}.params.npz")), cfg,
                         device="cpu")
    g = params_from_flat(grads_flat, cfg, device="cpu")
    opt = get_optimizer(name)
    opt.update(g, opt.init(p), p, 0, W.LR)
    return params_to_flat(p, period_len(cfg))

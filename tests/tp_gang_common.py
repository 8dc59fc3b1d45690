"""Helpers of the model-axis gang tests (``test_torch_tp_*.py``): the
reference's weights and tokens written once, a gang of
``torch_tp_worker.py`` ranks and the reference's ``fsdp_tp`` step
(``jax_tp_step.py``) started together, and the port's world-1 results on
the same weights and global batch to hold the gang against."""
import json
import os
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
from repro_torch.distributed import free_port
from repro_torch.launch.steps import shard_ctx_for
from repro_torch.models.model import decode_step, period_len, prefill
from repro_torch.optim import get_optimizer
from repro_torch.sharding import use_ctx
from repro_torch.train import make_loss_and_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.tree import tree_unflatten

import torch_tp_worker as W
from test_torch_campaign_chaos import ONE_THREAD

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
KEY = 13


def _env(**extra):
    src = str(ROOT / "src")
    path = os.environ.get("PYTHONPATH", "")
    return {**os.environ, **ONE_THREAD, **extra,
            "PYTHONPATH": src + (os.pathsep + path if path else "")}


def start(work: Path, cases: str, world: int, ref_devices: int) -> None:
    """Write the weights and tokens of every arch of ``cases``, run the
    gang of ``world`` ranks and the reference's sharded steps on a host
    mesh of ``ref_devices`` CPU devices (its training and its serving
    cases, each in a process of its own) side by side, and raise unless
    all exit 0."""
    files = {(a, a, ()) for a, _, _ in W.CASES[cases]}
    files |= {(c.name, c.arch, tuple(c.heads.items()))
              for c in W.SERVE[cases]}
    for name, arch, heads in files:
        np.savez(work / f"{name}.params.npz",
                 **_flatten(JM.init_params(
                     jax.random.PRNGKey(KEY),
                     W.config(jax_reduced, arch, dict(heads)))))
        np.save(work / f"{name}.tokens.npy", np.random.default_rng(5)
                .integers(0, get_reduced(arch).vocab, size=(W.B, W.S))
                .astype(np.int32))
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_tp_worker.py"), cases,
         str(r), str(world), coordinator, str(work)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    refs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_tp_step.py"), cases,
         str(work), str(KEY), part],
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count="
                           f"{ref_devices}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part, todo in (("train", W.REF), ("serve", W.REF_SERVE))
        if todo[cases]]
    outs = [p.communicate(timeout=400)[0] for p in procs + refs]
    assert [p.returncode for p in procs + refs] == [0] * len(outs), outs


def load(work: Path, rank: int, arch: str, mesh: dict):
    name = f"rank{rank}.{W.tag(arch, mesh)}"
    return (dict(np.load(work / f"{name}.npz")),
            json.loads((work / f"{name}.json").read_text()))


def world1(work: Path, arch: str, mesh: dict, serve: bool) -> dict:
    """The port's world-1 loss, gradients, steps and (``serve``) prefill
    and decode on the global batch, under the mesh's ctx (whose batch
    groups are the data rows' MoE dispatch groups)."""
    cfg = get_reduced(arch)
    flat = dict(np.load(work / f"{arch}.params.npz"))
    batch = W.global_batch(work, arch)
    out = {}
    with use_ctx(shard_ctx_for(mesh, "fsdp_tp")):
        params = params_from_flat(flat, cfg, device="cpu")
        loss, grads = make_loss_and_grads(cfg, loss_chunk=W.CHUNK)(params,
                                                                   batch)
        out["loss"] = float(loss)
        out["grad"] = params_to_flat(tree_unflatten(params, grads),
                                     period_len(cfg))
        for name in (cfg.optimizer, "lamb"):
            opt = get_optimizer(name)
            step = make_train_step(cfg, opt, lr_schedule=lambda s: W.LR,
                                   loss_chunk=W.CHUNK)
            p = params_from_flat(flat, cfg, device="cpu")
            _, metrics = step(TrainState(p, opt.init(p), 0), batch)
            out[name] = {k: float(metrics[k]) for k in ("loss",
                                                        "grad_norm")}
    if serve:
        out.update(world1_serve(params, cfg, batch, W.S + W.DECODE))
    return out


def world1_serve(params, cfg, batch, cache: int) -> dict:
    """The port's world-1 prefill into ``cache`` slots and ``DECODE``
    greedy steps: every step's logits, the state after the prefill and
    after the last step."""
    logits, state = prefill(params, cfg, batch, cache_len=cache)
    out = {"prefill_state": {k: v.clone() for k, v in state.items()},
           "logits": [logits]}
    tok = logits.argmax(-1)[:, None]
    for i in range(W.DECODE):
        pos = torch.full((tok.shape[0],), W.S + i, dtype=torch.int32)
        logits, state = decode_step(params, cfg, state, tok, pos)
        out["logits"].append(logits)
        tok = logits.argmax(-1)[:, None]
    out["decode_state"] = state
    return out


def world1_serve_case(work: Path, case) -> dict:
    """:func:`world1_serve` of a serve-only case (``W.Serve``)."""
    cfg = W.config(get_reduced, case.arch, case.heads)
    params = params_from_flat(dict(np.load(work / f"{case.name}.params.npz")),
                              cfg, device="cpu")
    return world1_serve(params, cfg, W.global_batch(work, case.name),
                        case.cache)


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


def close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                               err_msg=what)

"""One rank of a gang on a grid with a ``model`` axis (gloo on the CPU,
one thread), under ``fsdp_sp``: every case a test module of
``test_torch_sp_*.py`` needs, on the reduced f32 configs and the
reference's weights.

For each ``(arch, mesh, serve)`` of the case list named on the command
line (:data:`CASES`):

* ``make_loss_and_grads`` on the rank's blocks, its data row's rows and
  its model coordinate's block of the sequence: the loss, the gradients
  gathered whole (``FSDP.full_tree``), each block's and gradient block's
  shape, the local gradients of the leaves replicated over model (which
  the step all-reduces), the rank's block of one ``fsdp2`` leaf, and the
  collective bytes by mechanism;
* one step of the arch's optimizer and one LAMB step
  (``make_train_step``): their metrics and the parameters gathered;
* the flat-key round trip (``sharded_params_to_flat`` back through
  ``sharded_params_from_flat``) bitwise;
* where asked, a prefill of the rank's rows (``cache_len`` ``S``; the
  last position's logits of ``forward`` for the encoder-only arch): the
  logits, the rank's decode-state block shapes, the state gathered whole
  and the bytes by mechanism.

    python tests/torch_sp_worker.py CASES RANK WORLD COORDINATOR WORKDIR

The serving lists (:data:`RUNS`: decode, and the MoE archs) take a
:class:`Run` each instead: a train step as above where it says so (its
bytes and its arch optimizer's step), then a prefill of ``seq`` tokens
into a cache of ``cache`` slots and ``decode`` steps fed
:func:`decode_tokens`: every step's logits, the rank's blocks of the
decode state after the last step, and the bytes of the prefill and of
each decode step.

``WORKDIR`` holds ``<arch>.params.npz`` (the reference's weights in
checkpoint layout) and ``<arch>.batch.npz`` (the global batch; a run's
``<tag>.batch.npz``); it receives ``rank{r}.<tag>.npz`` and
``rank{r}.<tag>.json``.
"""
import json
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.convert import (params_from_flat, params_to_flat,
                                 sharded_params_from_flat,
                                 sharded_params_to_flat)
from repro_torch.distributed.context import init_distributed
from repro_torch.distributed.data import shard_rows
from repro_torch.models.model import decode_step, forward, period_len, prefill
from repro_torch.optim import get_optimizer
from repro_torch.sharding.fsdp import FSDP
from repro_torch.sharding.grid import RankGrid
from repro_torch.train import make_loss_and_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.tree import tree_leaves, tree_unflatten

# S splits into blocks of 64 (past the reduced window of 64, at least
# mamba2's chunk of 32); the loss chunk of 48 crosses the block boundary
B, S, CHUNK = 4, 128, 48
LR = 1e-3
D1M2 = {"data": 1, "model": 2}
D2M2 = {"data": 2, "model": 2}
ARCHS = ("stablelm-1.6b", "granite-3-2b", "mamba2-2.7b", "hubert-xlarge",
         "llava-next-mistral-7b")
# (arch, mesh, serve?) by case list: the world-2 gang's and the world-4's
CASES = {
    "model2": [(a, D1M2, True) for a in ARCHS],
    "world4": [("stablelm-1.6b", D2M2, False), ("mamba2-2.7b", D2M2, False)],
}
# the cases the reference's own fsdp_sp step runs (jax_sp_step.py)
REF = {"model2": [c for c in CASES["model2"]
                  if c[0] in ("stablelm-1.6b", "mamba2-2.7b")]}
DECODE = 4


class Run(NamedTuple):
    """A serving case of the ``{data: 1, model: 2}`` gang: a train step
    where ``train``, then a prefill of ``seq`` tokens into a cache of
    ``cache`` slots and ``decode`` steps."""

    arch: str
    seq: int
    train: bool
    cache: int
    decode: int = DECODE
    mesh: dict = D1M2

    @property
    def tag(self) -> str:
        return f"{tag(self.arch, self.mesh)}.s{self.seq}.c{self.cache}"


RUNS = {
    "decode": [
        Run("stablelm-1.6b", S, False, S + DECODE),
        Run("mamba2-2.7b", S, False, S + DECODE),
        # a cache of 64 slots after an 8-token prompt: rank 1's 32 slots
        # are all masked in every step
        Run("stablelm-1.6b", 8, False, 64),
        # blocks of 16 under mamba2's chunk of 32: the whole-sequence
        # fallback
        Run("mamba2-2.7b", 32, True, 32 + DECODE),
    ],
    "moe": [
        Run("qwen3-moe-30b-a3b", S, True, S + DECODE),
        Run("jamba-1.5-large-398b", S, True, S + DECODE),
    ],
}


def decode_tokens(arch: str, steps: int = DECODE) -> np.ndarray:
    """The (steps, B, 1) int32 tokens each decode step takes."""
    return np.random.default_rng(7).integers(
        0, get_reduced(arch).vocab, size=(steps, B, 1)).astype(np.int32)


# the init's A = -exp(A_log) of -1 .. -16 forgets a state within a few
# tokens, so a block's incoming state would add nothing: the SSD archs
# take A of -1e-3 .. -1e-2 (a state carries across a block of 64)
SLOW_A_LOG = (1e-3, 1e-2)


def slow_decay(flat: dict) -> dict:
    """The checkpoint-layout weights with every SSD layer's ``A_log``
    set from :data:`SLOW_A_LOG`."""
    for key, a in flat.items():
        if key.endswith("ssm/A_log"):
            flat[key] = np.broadcast_to(np.log(np.linspace(
                *SLOW_A_LOG, a.shape[-1], dtype=np.float32)), a.shape).copy()
    return flat


def tag(arch: str, mesh: dict) -> str:
    return arch + "." + "x".join(f"{a}{n}" for a, n in mesh.items())


def global_batch(work: Path, arch: str):
    return {k: torch.from_numpy(v) for k, v in
            np.load(work / f"{arch}.batch.npz").items()}


def _flat(params, cfg, prefix):
    return {f"{prefix}/{k}": v
            for k, v in params_to_flat(params, period_len(cfg)).items()}


def _since(ctx, before):
    return {k: v - before.get(k, 0.0) for k, v in
            ctx.collective_bytes.items() if v - before.get(k, 0.0)}


def run_case(ctx, work: Path, arch: str, mesh: dict, serve: bool) -> None:
    cfg = get_reduced(arch)
    grid = RankGrid(mesh, ctx)
    flat = dict(np.load(work / f"{arch}.params.npz"))
    full = params_from_flat(flat, cfg, device="cpu")
    fsdp = FSDP(grid, full, "fsdp_sp", cfg)
    rows = shard_rows(global_batch(work, arch), grid.coord("data"),
                      grid.extent("data"))
    out, info = {}, {"coords": grid.coords,
                     "groups": {a: list(grid.group(a).ranks)
                                for a in ("data", "model", "world")}}
    shards = fsdp.shard_tree(full)
    # the first leaf split over both axes: its block, by leaf index
    axes = tree_leaves(fsdp.axes)
    first = next((i for i, a in enumerate(axes) if a in ("plane", "model")
                  and tree_leaves(fsdp.model_dims)[i] is None), None)
    info["fsdp2_leaf"] = first
    info["axes"] = axes
    out["fsdp2_block"] = tree_leaves(shards)[first].numpy()
    before = dict(ctx.collective_bytes)
    fn = make_loss_and_grads(cfg, loss_chunk=CHUNK, dist=ctx, fsdp=fsdp)
    loss, grads = fn(shards, rows)
    info["bytes"] = _since(ctx, before)
    info["shard_shapes"] = [list(t.shape) for t in tree_leaves(shards)]
    info["grad_shapes"] = [list(g.shape) for g in grads]
    info["reduce"] = [sorted(r) for r in fsdp.reduce]
    out["loss"] = loss.numpy()
    for i, (g, r) in enumerate(zip(grads, fsdp.reduce)):
        if "model" in r:
            out[f"local_grad/{i}"] = g.numpy()
    out.update(_flat(fsdp.full_tree(tree_unflatten(shards, grads)), cfg,
                     "grad"))
    for name in (cfg.optimizer, "lamb"):
        opt = get_optimizer(name)
        step = make_train_step(cfg, opt, lr_schedule=lambda s: LR,
                               loss_chunk=CHUNK, dist=ctx, fsdp=fsdp)
        # shard_tree keeps the replicated leaves: a fresh full tree
        p = fsdp.shard_tree(params_from_flat(flat, cfg, device="cpu"))
        state, metrics = step(TrainState(p, opt.init(p), 0), rows)
        info[name] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        out.update(_flat(fsdp.full_tree(state.params), cfg, name))
    back = sharded_params_from_flat(
        sharded_params_to_flat(shards, fsdp, period_len(cfg)), cfg,
        fsdp, device="cpu")
    info["round_trip_bitwise"] = all(
        torch.equal(a, b) and a.dtype == b.dtype
        for a, b in zip(tree_leaves(back), tree_leaves(shards)))
    if serve:
        before = dict(ctx.collective_bytes)
        if cfg.is_encoder_only:
            with torch.no_grad():
                logits = forward(shards, cfg, rows, remat=False,
                                 fsdp=fsdp)[:, -1, :]
            state = {}
        else:
            logits, state = prefill(shards, cfg, rows, cache_len=S,
                                    fsdp=fsdp)
        info["prefill_bytes"] = _since(ctx, before)
        info["state_shapes"] = {k: list(v.shape) for k, v in state.items()}
        out.update({f"prefill_state/{k}": v.numpy() for k, v in
                    fsdp.sp.full_decode_state(state, cfg, S).items()})
        out["logits"] = logits.numpy()
    name = f"rank{ctx.rank}.{tag(arch, mesh)}"
    np.savez(work / f"{name}.npz", **out)
    (work / f"{name}.json").write_text(json.dumps(info))


def run_serving(ctx, work: Path, run: Run) -> None:
    """One :class:`Run` on this rank."""
    cfg = get_reduced(run.arch)
    grid = RankGrid(run.mesh, ctx)
    flat = dict(np.load(work / f"{run.arch}.params.npz"))
    fsdp = FSDP(grid, params_from_flat(flat, cfg, device="cpu"), "fsdp_sp",
                cfg)
    rows = {k: torch.from_numpy(v) for k, v in
            np.load(work / f"{run.tag}.batch.npz").items()}
    out, info = {}, {}
    if run.train:
        shards = fsdp.shard_tree(params_from_flat(flat, cfg, device="cpu"))
        before = dict(ctx.collective_bytes)
        loss, grads = make_loss_and_grads(cfg, loss_chunk=CHUNK, dist=ctx,
                                          fsdp=fsdp)(shards, rows)
        info["bytes"] = _since(ctx, before)
        out["loss"] = loss.numpy()
        out.update(_flat(fsdp.full_tree(tree_unflatten(shards, grads)),
                         cfg, "grad"))
        opt = get_optimizer(cfg.optimizer)
        step = make_train_step(cfg, opt, lr_schedule=lambda s: LR,
                               loss_chunk=CHUNK, dist=ctx, fsdp=fsdp)
        p = fsdp.shard_tree(params_from_flat(flat, cfg, device="cpu"))
        _, metrics = step(TrainState(p, opt.init(p), 0), rows)
        info["step"] = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
    shards = fsdp.shard_tree(params_from_flat(flat, cfg, device="cpu"))
    before = dict(ctx.collective_bytes)
    logits, state = prefill(shards, cfg, rows, cache_len=run.cache,
                            fsdp=fsdp)
    info["prefill_bytes"] = _since(ctx, before)
    steps, info["decode_bytes"] = [logits], []
    for i, tok in enumerate(decode_tokens(run.arch, run.decode)):
        pos = torch.full((B,), run.seq + i, dtype=torch.int32)
        before = dict(ctx.collective_bytes)
        logits, state = decode_step(shards, cfg, state, torch.from_numpy(tok),
                                    pos, fsdp=fsdp, cache_len=run.cache)
        info["decode_bytes"].append(_since(ctx, before))
        steps.append(logits)
    out["logits"] = torch.stack(steps).numpy()
    out.update({f"state/{k}": v.numpy() for k, v in state.items()})
    info["state_shapes"] = {k: list(v.shape) for k, v in state.items()}
    name = f"rank{ctx.rank}.{run.tag}"
    np.savez(work / f"{name}.npz", **out)
    (work / f"{name}.json").write_text(json.dumps(info))


def main(cases: str, rank: int, world: int, coordinator: str,
         work: Path) -> None:
    torch.set_num_threads(1)
    ctx = init_distributed(world, rank, coordinator, "cpu")
    try:
        if cases in RUNS:
            for run in RUNS[cases]:
                run_serving(ctx, work, run)
        else:
            for arch, mesh, serve in CASES[cases]:
                run_case(ctx, work, arch, mesh, serve)
    finally:
        ctx.close()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         Path(sys.argv[5]))

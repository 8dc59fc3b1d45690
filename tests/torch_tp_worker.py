"""One rank of a gang on a grid with a ``model`` axis (gloo on the CPU,
one thread), under ``fsdp_tp``: every case a test module of
``test_torch_tp_*.py`` needs, on the reduced f32 configs and the
reference's weights.

For each ``(arch, mesh)`` of the case list named on the command line
(:data:`CASES`):

* ``make_loss_and_grads`` on the rank's blocks and rows: the loss, the
  gradients gathered whole (``FSDP.full_tree``), each block's and
  gradient block's shape, and the collective bytes by mechanism;
* one step of the arch's optimizer and one LAMB step
  (``make_train_step``): their metrics and the parameters gathered;
* the flat-key round trip (``sharded_params_to_flat`` back through
  ``sharded_params_from_flat``) bitwise;
* where asked, a prefill of the rank's rows (``cache_len`` ``S +
  DECODE``) and ``DECODE`` greedy decode steps: each step's whole
  logits, the decode state gathered whole after the prefill and after
  the last step, the rank's decode-state bytes after each, and the
  bytes by mechanism of the prefill and of one decode step.

Then each serve-only case of :data:`SERVE` (a reduced config with its
heads replaced, a cache of its own length): the same prefill and decode
steps, without training.

    python tests/torch_tp_worker.py CASES RANK WORLD COORDINATOR WORKDIR

``WORKDIR`` holds ``<arch>.params.npz`` (the reference's weights in
checkpoint layout) and ``<arch>.tokens.npy`` (a serve-only case's under
its name); it receives ``rank{r}.<tag>.npz`` and ``rank{r}.<tag>.json``,
``tag`` being :func:`tag`.
"""
import dataclasses
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
from repro_torch.models.model import decode_step, period_len, prefill
from repro_torch.models.model import init_decode_state
from repro_torch.optim import get_optimizer
from repro_torch.sharding.fsdp import FSDP
from repro_torch.sharding.grid import RankGrid
from repro_torch.train import make_loss_and_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.tree import tree_leaves, tree_unflatten

B, S, CHUNK, DECODE = 4, 16, 6, 4
LR = 1e-3
M2 = {"model": 2}
M4 = {"model": 4}
D2M2 = {"data": 2, "model": 2}
# (arch, mesh, serve?) by case list: the world-2 gang's and the world-4's
CASES = {
    "model2": [("stablelm-1.6b", M2, True), ("mamba2-2.7b", M2, True),
               ("qwen3-moe-30b-a3b", M2, True),
               ("jamba-1.5-large-398b", M2, True)],
    "world4": [("stablelm-1.6b", D2M2, False),
               ("qwen3-moe-30b-a3b", D2M2, False),
               ("stablelm-1.6b", M4, True), ("mamba2-2.7b", M4, True)],
}


# the cases the reference's own fsdp_tp step runs (jax_tp_step.py)
REF = {"model2": CASES["model2"][:3], "world4": CASES["world4"][:2]}


class Serve(NamedTuple):
    """A serve-only case: the reduced ``arch`` with ``heads`` replaced,
    a prefill into a cache of ``cache`` slots and ``DECODE`` greedy
    steps on ``mesh``; its files go by ``name``."""
    name: str
    arch: str
    heads: dict
    cache: int
    mesh: dict = M2


# the decode branches the cases above leave: a kv head both ranks share
# (granite with one kv head: each rank's two query heads read it), the
# attention whole (3 query heads on 2 ranks, as llama4's 40 on 16), and
# a cache the model axis does not divide (kept whole on every rank)
SERVE = {"model2": [
    Serve("granite-kv1", "granite-3-2b", {"n_kv_heads": 1}, S + DECODE),
    Serve("llama4-whole", "llama4-maverick-400b-a17b",
          {"n_heads": 3, "n_kv_heads": 1, "d_head": 64}, S + DECODE),
    Serve("stablelm-odd-cache", "stablelm-1.6b", {}, S + DECODE + 1)],
    "world4": []}


def serve_cases(cases: str) -> list:
    """``(name, arch, heads, cache, mesh)`` of every case of ``cases``
    that serves: the train cases' at a cache of ``S + DECODE``, then
    :data:`SERVE`'s."""
    return [Serve(a, a, {}, S + DECODE, m) for a, m, serve in CASES[cases]
            if serve] + SERVE[cases]


# the serving cases the reference's own fsdp_tp prefill and decode run:
# one for each decode branch (M dividing the kv heads, an SSM with fewer
# groups than ranks, then SERVE's three); world 1 holds the others
REF_SERVE = {"model2": serve_cases("model2")[:2] + SERVE["model2"],
             "world4": []}


def config(get_reduced, arch: str, heads: dict):
    """Either package's reduced config of ``arch`` with ``heads``."""
    return dataclasses.replace(get_reduced(arch), **heads)


def tag(arch: str, mesh: dict) -> str:
    return arch + "." + "x".join(f"{a}{n}" for a, n in mesh.items())


def global_batch(work: Path, arch: str):
    """The reference's text batch: tokens only, each position scored
    against the next."""
    return {"tokens": torch.from_numpy(np.load(work / f"{arch}.tokens.npy"))}


def _nbytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


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
    fsdp = FSDP(grid, full, "fsdp_tp", cfg)
    rows = shard_rows(global_batch(work, arch), grid.coord("data"),
                      grid.extent("data"))
    out, info = {}, {"coords": grid.coords,
                     "groups": {a: list(grid.group(a).ranks)
                                for a in ("data", "model")}}
    shards = fsdp.shard_tree(full)
    before = dict(ctx.collective_bytes)
    fn = make_loss_and_grads(cfg, loss_chunk=CHUNK, dist=ctx, fsdp=fsdp)
    loss, grads = fn(shards, rows)
    info["bytes"] = _since(ctx, before)
    info["shard_shapes"] = [list(t.shape) for t in tree_leaves(shards)]
    info["grad_shapes"] = [list(g.shape) for g in grads]
    out["loss"] = loss.numpy()
    out.update(_flat(fsdp.full_tree(tree_unflatten(shards, grads)), cfg,
                     "grad"))
    for name in (cfg.optimizer, "lamb"):
        opt = get_optimizer(name)
        step = make_train_step(cfg, opt, lr_schedule=lambda s: LR,
                               loss_chunk=CHUNK, dist=ctx, fsdp=fsdp)
        # shard_tree keeps the replicated leaves: a fresh full tree
        p = fsdp.shard_tree(params_from_flat(flat, cfg, device="cpu"))
        state, metrics = step(TrainState(p, opt.init(p), 0), rows)
        info[name] = {k: float(metrics[k]) for k in ("loss",
                                                     "grad_norm")}
        out.update(_flat(fsdp.full_tree(state.params), cfg, name))
    back = sharded_params_from_flat(
        sharded_params_to_flat(shards, fsdp, period_len(cfg)), cfg,
        fsdp, device="cpu")
    info["round_trip_bitwise"] = all(
        torch.equal(a, b) and a.dtype == b.dtype
        for a, b in zip(tree_leaves(back), tree_leaves(shards)))
    if serve:
        _serve(ctx, grid, fsdp, shards, cfg, rows, S + DECODE, out, info)
    name = f"rank{ctx.rank}.{tag(arch, mesh)}"
    np.savez(work / f"{name}.npz", **out)
    (work / f"{name}.json").write_text(json.dumps(info))


def _serve(ctx, grid, fsdp, shards, cfg, rows, cache: int, out: dict,
           info: dict) -> None:
    """A prefill of ``rows`` into ``cache`` slots and ``DECODE`` greedy
    steps on the rank's blocks: into ``out`` every step's whole logits
    and the state gathered whole after the prefill and the last step;
    into ``info`` the rank's state shapes and bytes and the bytes by
    mechanism of the prefill and of the last decode step."""
    tp = fsdp.tp
    before = dict(ctx.collective_bytes)
    logits, state = prefill(shards, cfg, rows, cache_len=cache, fsdp=fsdp)
    info["prefill_bytes"] = _since(ctx, before)
    info["state_shapes"] = {k: list(v.shape) for k, v in state.items()}
    info["state_bytes"] = {"prefill": _nbytes(state)}
    info["init_state_shapes"] = {
        k: list(v.shape) for k, v in init_decode_state(
            cfg, rows["tokens"].shape[0], cache, device="cpu",
            grid=grid).items()}
    out.update({f"prefill_state/{k}": v.numpy() for k, v in
                tp.full_decode_state(state, cfg, cache).items()})
    out["logits/0"] = logits.numpy()
    tok = logits.argmax(-1)[:, None]
    for i in range(DECODE):
        before = dict(ctx.collective_bytes)
        pos = torch.full((tok.shape[0],), S + i, dtype=torch.int32)
        logits, state = decode_step(shards, cfg, state, tok, pos,
                                    fsdp=fsdp, cache_len=cache)
        info["decode_bytes"] = _since(ctx, before)
        out[f"logits/{i + 1}"] = logits.numpy()
        tok = logits.argmax(-1)[:, None]
    info["state_bytes"]["decode"] = _nbytes(state)
    out.update({f"decode_state/{k}": v.numpy() for k, v in
                tp.full_decode_state(state, cfg, cache).items()})


def serve_case(ctx, work: Path, case: Serve) -> None:
    """A serve-only case: the prefill and decode steps of :func:`_serve`
    on the case's config, weights and tokens."""
    cfg = config(get_reduced, case.arch, case.heads)
    grid = RankGrid(case.mesh, ctx)
    full = params_from_flat(dict(np.load(work / f"{case.name}.params.npz")),
                            cfg, device="cpu")
    fsdp = FSDP(grid, full, "fsdp_tp", cfg)
    rows = shard_rows(global_batch(work, case.name), grid.coord("data"),
                      grid.extent("data"))
    out, info = {}, {"coords": grid.coords}
    _serve(ctx, grid, fsdp, fsdp.shard_tree(full), cfg, rows, case.cache,
           out, info)
    name = f"rank{ctx.rank}.{tag(case.name, case.mesh)}"
    np.savez(work / f"{name}.npz", **out)
    (work / f"{name}.json").write_text(json.dumps(info))


def main(cases: str, rank: int, world: int, coordinator: str,
         work: Path) -> None:
    torch.set_num_threads(1)
    ctx = init_distributed(world, rank, coordinator, "cpu")
    try:
        for arch, mesh, serve in CASES[cases]:
            run_case(ctx, work, arch, mesh, serve)
        for case in SERVE[cases]:
            serve_case(ctx, work, case)
    finally:
        ctx.close()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         Path(sys.argv[5]))

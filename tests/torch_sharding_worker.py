"""One rank of the world-2 gang that ``test_torch_sharding_gang.py``
starts once per module (gloo on the CPU, one thread): every sharded case
it needs, on the reduced f32 configs and the reference's weights.

For each ``(arch, layout)`` of ``CASES`` (stablelm, mamba2 and qwen3-moe
under ``fsdp_tp`` and ``fsdp_sp``, on the data grid ``{"data": 2}``):

* ``make_loss_and_grads`` on the rank's shards and rows: the loss, the
  gradients gathered whole (``FSDP.full_tree``), the shape of each shard
  the rank held and of each gradient shard, and the collective bytes by
  mechanism;
* one AdamW ``make_train_step`` (the arch's optimizer) and one LAMB
  step: their metrics and the updated parameters gathered whole;
* the flat-key round trip: ``sharded_params_to_flat`` back through
  ``sharded_params_from_flat`` bitwise equal to the shards.

    python tests/torch_sharding_worker.py RANK COORDINATOR WORKDIR

``WORKDIR`` holds ``<arch>.params.npz`` (the reference's weights in
checkpoint layout) and ``<arch>.tokens.npy``; it receives
``rank{r}.<arch>.<layout>.npz`` and ``rank{r}.<arch>.<layout>.json``.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.convert import (params_from_flat, params_to_flat,
                                 sharded_params_from_flat,
                                 sharded_params_to_flat)
from repro_torch.distributed.context import init_distributed
from repro_torch.distributed.data import shard_rows
from repro_torch.models.model import period_len
from repro_torch.optim import get_optimizer
from repro_torch.sharding.fsdp import FSDP
from repro_torch.sharding.grid import data_grid
from repro_torch.train import make_loss_and_grads, make_train_step
from repro_torch.train.step import TrainState
from repro_torch.tree import tree_leaves, tree_unflatten

ARCHS = ("stablelm-1.6b", "mamba2-2.7b", "qwen3-moe-30b-a3b")
LAYOUTS = ("fsdp_tp", "fsdp_sp")
CASES = [(a, lay) for a in ARCHS for lay in LAYOUTS]
B, S, CHUNK = 4, 16, 6
LR = 1e-3


def global_batch(work: Path, arch: str):
    """The reference's text batch: tokens only, each position scored
    against the next."""
    return {"tokens": torch.from_numpy(np.load(work / f"{arch}.tokens.npy"))}


def _flat(params, cfg, prefix):
    return {f"{prefix}/{k}": v
            for k, v in params_to_flat(params, period_len(cfg)).items()}


def run_case(ctx, grid, work: Path, arch: str, layout: str) -> None:
    cfg = get_reduced(arch)
    flat = dict(np.load(work / f"{arch}.params.npz"))
    full = params_from_flat(flat, cfg, device="cpu")
    fsdp = FSDP(grid, full, layout)
    rows = shard_rows(global_batch(work, arch), ctx.rank, ctx.world_size)
    out, info = {}, {}
    ctx.collective_bytes.clear()
    shards = fsdp.shard_tree(full)
    fn = make_loss_and_grads(cfg, loss_chunk=CHUNK, dist=ctx, fsdp=fsdp)
    loss, grads = fn(shards, rows)
    info["bytes"] = dict(ctx.collective_bytes)
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
    tag = f"rank{ctx.rank}.{arch}.{layout}"
    np.savez(work / f"{tag}.npz", **out)
    (work / f"{tag}.json").write_text(json.dumps(info))


def main(rank: int, coordinator: str, work: Path) -> None:
    torch.set_num_threads(1)
    ctx = init_distributed(2, rank, coordinator, "cpu")
    try:
        grid = data_grid(ctx)
        for arch, layout in CASES:
            run_case(ctx, grid, work, arch, layout)
    finally:
        ctx.close()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

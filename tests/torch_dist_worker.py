"""One rank of the world-2 gang that ``test_torch_distributed.py`` starts
once per module (gloo on the CPU, one thread), computing every case it
needs:

* ``hubert-mb1`` / ``hubert-mb2``: reduced hubert-xlarge's global loss
  and gradients (``make_loss_and_grads`` with the rank's context) on
  ``make_batch(cfg, 4, 16, seed=3)``, at 1 and 2 microbatches;
* ``moe``: the same for reduced qwen3-moe-30b-a3b on a seeded token
  batch;
* ``agree``: two ``DistributedTrainLoop`` resumes, first from one shared
  checkpoint directory, then rank r from ``ck_r{r}`` (published steps
  that differ), which must raise on every rank.

    python tests/torch_dist_worker.py RANK COORDINATOR WORKDIR

``WORKDIR`` holds the parent's inputs (``<case>.params.npz``, the
reference's parameters in checkpoint layout; ``tokens.npy``; the
checkpoint directories) and receives ``rank{r}.<case>.npz`` (the loss
and every gradient leaf in checkpoint layout) and ``rank{r}.agree.json``.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_flat, params_to_flat
from repro_torch.data.inputs import make_batch
from repro_torch.distributed.context import init_distributed
from repro_torch.distributed.data import shard_rows
from repro_torch.distributed.trainer import DistributedTrainLoop
from repro_torch.models.model import period_len
from repro_torch.optim import get_optimizer
from repro_torch.train import init_train_state, make_loss_and_grads
from repro_torch.tree import tree_unflatten

CASES = {"hubert-mb1": ("hubert-xlarge", 1),
         "hubert-mb2": ("hubert-xlarge", 2),
         "moe": ("qwen3-moe-30b-a3b", 1)}
B, S, CHUNK, BATCH_SEED = 4, 16, 6, 3


def global_batch(cfg, work: Path):
    if cfg.family == "audio":
        return make_batch(cfg, B, S, seed=BATCH_SEED, device="cpu")
    toks = torch.from_numpy(np.load(work / "tokens.npy"))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def main(rank: int, coordinator: str, work: Path) -> None:
    torch.set_num_threads(1)
    ctx = init_distributed(2, rank, coordinator, "cpu")
    try:
        for case, (arch, mbs) in CASES.items():
            cfg = get_reduced(arch)
            flat = dict(np.load(work / f"{case}.params.npz"))
            params = params_from_flat(flat, cfg, device="cpu")
            fn = make_loss_and_grads(cfg, microbatches=mbs,
                                     loss_chunk=CHUNK, dist=ctx)
            rows = shard_rows(global_batch(cfg, work), rank, 2)
            loss, grads = fn(params, rows)
            out = params_to_flat(tree_unflatten(params, grads),
                                 period_len(cfg))
            np.savez(work / f"rank{rank}.{case}.npz", loss=loss.numpy(),
                     **{f"grad/{k}": v for k, v in out.items()})

        cfg = get_reduced("stablelm-1.6b")
        opt = get_optimizer(cfg.optimizer)
        found = {}
        for label, directory in (("same", "ck_r0"), ("differ", f"ck_r{rank}")):
            state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                     opt, device="cpu")
            ckpt = CheckpointManager(work / directory, every_steps=0,
                                     async_saves=False,
                                     period=period_len(cfg))
            loop = DistributedTrainLoop(None, state, None, ctx=ctx,
                                        checkpointer=ckpt)
            try:
                loop.resume()
                found[label] = {"start_step": loop.start_step}
            except RuntimeError as e:
                found[label] = {"error": str(e)}
        (work / f"rank{rank}.agree.json").write_text(json.dumps(found))
    finally:
        ctx.close()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))

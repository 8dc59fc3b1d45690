"""Training launcher.

``python -m repro_torch.launch.train --arch <id> [--full] --steps N``

Port of ``repro.launch.train::train_main``: the reduced config of ``arch``
(or the full one with ``reduced=False``), random weights from ``seed``, the
seekable Markov token stream (for the vlm and audio families the seekable
synthetic patch/frame batches of ``repro_torch.data.inputs``), and :class:`repro_torch.train.TrainLoop` with
optional atomic checkpoints of the full ``TrainState`` plus the data
cursor, ``resume`` from the newest valid one, the ``preempt_at_step``
fault hook, and with ``s3_root`` the export of the checkpoint directory to
an :class:`~repro_torch.core.artifacts.S3Store` after training.  Runs on
``cuda`` unless ``device`` (``--device``) says otherwise.  A data-parallel
gang (``--world_size N``) runs its ranks through
:func:`repro_torch.distributed.dist_train_main`, which shares
:func:`run_rank` with this single process.

The command line is a thin shim over the port's run API: it builds a
``train`` :class:`~repro_torch.api.RunSpec`, runs it through the registry
(``python -m repro_torch.launch run train`` is the same run), prints the
report's metrics as JSON and exits 1 if the run failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.checkpoint import CheckpointManager, export_to_s3
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.artifacts import S3Store
from repro_torch.data.inputs import SeekableSyntheticBatches
from repro_torch.data.tokens import SeekableTokenBatches
from repro_torch.distributed.context import init_distributed, params_checksum
from repro_torch.distributed.data import ShardedBatches
from repro_torch.distributed.trainer import DistributedTrainLoop
from repro_torch.models.model import period_len
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import tree_leaves


class _LMDictBatches(SeekableTokenBatches):
    """Seekable LM stream yielding model-ready {'tokens','labels'} dicts
    on ``device``."""

    def __init__(self, vocab, batch, seq, seed, device):
        super().__init__(vocab, batch, seq, seed)
        self.device = device

    def next_batch(self):
        toks, labels = super().next_batch()
        return {"tokens": torch.from_numpy(toks).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}


def train_main(arch: str, *, device=None, **kw) -> dict:
    """Train ``arch`` in this process on ``device`` (default ``cuda``)
    and return the result dict; the keywords are :func:`run_rank`'s."""
    return run_rank(arch, init_distributed(1, device=device), **kw)[0]


def run_rank(arch: str, ctx, *, reduced: bool = True, steps: int = 100,
             batch: int = 8, seq: int = 128, lr: float = 3e-4,
             optimizer: str = None, seed: int = 0,
             checkpoint_dir: str = None, s3_root: str = None,
             log_every: int = 10, checkpoint_every: int = 0,
             checkpoint_keep: int = 3, checkpoint_async: bool = True,
             resume: bool = False, preempt_at_step: int = None,
             precision: str = "f32", grad_clip: float = None,
             microbatches: int = 1, attention_backend: str = None,
             mixer_backend: str = None) -> tuple:
    """One rank's training run on ``ctx.device`` (a
    :class:`repro_torch.distributed.DistContext`; world 1 is the single
    process).  ``batch`` is the global batch.  Returns the result dict
    and the loop.  Rank 0 alone writes checkpoints (on cadence, on
    SIGTERM and at the end), logs and exports; every rank restores."""
    device = ctx.device
    cfg = get_reduced(arch) if reduced else get_config(arch)
    backends = {}
    if attention_backend:
        backends["attention_backend"] = attention_backend
    if mixer_backend:
        backends["mixer_backend"] = mixer_backend
    if backends:
        cfg = dataclasses.replace(cfg, **backends)
    opt = get_optimizer(optimizer or cfg.optimizer)
    state = init_train_state(
        torch.Generator(device=device).manual_seed(seed), cfg, opt,
        device=device)
    if ctx.world_size > 1:
        # every rank drew its parameters from the same seed
        ctx.agree(params_checksum(tree_leaves(state.params)),
                  "initial parameters")
    step_fn = make_train_step(
        cfg, opt, lr_schedule=warmup_cosine(lr, steps,
                                            warmup_steps=max(steps // 10, 1)),
        precision=precision, grad_clip=grad_clip,
        microbatches=max(1, int(microbatches)), dist=ctx)
    # the global stream on the host; each rank copies its rows over
    text_lm = cfg.family in ("dense", "moe", "ssm", "hybrid")
    inner = (_LMDictBatches(cfg.vocab, batch, seq, seed, "cpu") if text_lm
             else SeekableSyntheticBatches(cfg, batch, seq, seed,
                                           device="cpu"))
    data = ShardedBatches(inner, ctx)

    lead = ctx.is_coordinator
    ckpt = None
    if checkpoint_dir:
        # one shared directory: rank 0 writes, every rank restores
        ckpt = CheckpointManager(checkpoint_dir,
                                 keep_last=max(int(checkpoint_keep), 1),
                                 every_steps=int(checkpoint_every) if lead
                                 else 0,
                                 async_saves=bool(checkpoint_async) and lead,
                                 period=period_len(cfg))
    # only rank 0 saves on SIGTERM; the others die with the signal and
    # the gang is requeued as one
    loop = DistributedTrainLoop(step_fn, state, data, ctx=ctx,
                                checkpointer=ckpt,
                                preempt_at_step=preempt_at_step,
                                log_every=log_every if lead else 0,
                                sigterm_save=lead)
    if resume:
        loop.resume()
    try:
        run = loop.run(steps)
    finally:
        if ckpt is not None:
            ckpt.wait()
    if ctx.world_size > 1:
        # the summed gradients kept every rank's parameters equal
        ctx.agree(params_checksum(tree_leaves(loop.state.params)),
                  "final parameters")

    result = {"arch": cfg.name, "params": cfg.param_count(),
              "device": str(device), **run}
    if steps <= 512:
        # trajectories for oracle comparisons, bounded for long runs
        result["losses"] = list(loop.losses)
    if ckpt is not None:
        if lead:
            loop.save_final(extra={"arch": cfg.name,
                                   "final_loss": run.get("final_loss")})
        overhead = result.get("checkpoint", {}).get("overhead_frac", 0.0)
        result["checkpoint"] = {**ckpt.stats(), "overhead_frac": overhead}
        ckpt.close()
        if s3_root and lead:
            s3 = S3Store(s3_root)
            n = export_to_s3(checkpoint_dir, s3, f"models/{cfg.name}")
            result["s3_objects"] = n
    return result, loop


def main(argv=None):
    # thin shim over the repro_torch.api registry (RunSpec in, RunReport out)
    from repro_torch.api import RunSpec, run
    from repro_torch.api.runners.train import BACKEND_NAMES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=os.environ.get("ARCH", "stablelm-1.6b"))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("STEPS", 100)))
    ap.add_argument("--batch", type=int,
                    default=int(os.environ.get("BATCH", 8)))
    ap.add_argument("--seq", type=int, default=int(os.environ.get("SEQ", 128)))
    ap.add_argument("--lr", type=float, default=float(os.environ.get("LR", 3e-4)))
    ap.add_argument("--optimizer", default=os.environ.get("OPTIMIZER"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the full TrainState every N steps")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint before "
                         "training")
    ap.add_argument("--preempt-at-step", type=int, default=None,
                    help="fault hook: raise Preemption before this step")
    ap.add_argument("--s3-root", default=None,
                    help="export the checkpoint directory to this S3 store "
                         "after training")
    ap.add_argument("--precision", default=os.environ.get("PRECISION", "f32"),
                    choices=["f32", "bf16"],
                    help="mixed-precision policy: bf16 = bf16 "
                         "compute/activations")
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="clip the global gradient norm to this value")
    ap.add_argument("--attention-backend", default=None,
                    choices=sorted(BACKEND_NAMES),
                    help="attention kernel backend (default: the config's, "
                         "'auto' = the CUDA kernels on the card; the "
                         "reference's jnp / pallas mean torch / cuda)")
    ap.add_argument("--mixer-backend", default=None,
                    choices=sorted(BACKEND_NAMES),
                    help="SSD mixer kernel backend, as --attention-backend")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation chunks per step")
    ap.add_argument("--world-size", type=int, default=1,
                    help="data-parallel ranks (a gang of processes; "
                         "--batch is the global batch)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    overrides = {"full": args.full, "steps": args.steps, "batch": args.batch,
                 "seq": args.seq, "lr": args.lr,
                 "log_every": args.log_every}
    optional = {"optimizer": args.optimizer,
                "grad_clip": args.grad_clip,
                "attention_backend": args.attention_backend,
                "mixer_backend": args.mixer_backend,
                "checkpoint_dir": args.checkpoint_dir,
                "preempt_at_step": args.preempt_at_step,
                "s3_root": args.s3_root, "device": args.device}
    overrides.update({k: v for k, v in optional.items() if v is not None})
    if args.precision != "f32":
        overrides["precision"] = args.precision
    if args.checkpoint_every:
        overrides["checkpoint_every"] = args.checkpoint_every
    if args.resume:
        overrides["resume"] = True
    if args.world_size != 1:
        overrides["world_size"] = args.world_size
    if args.microbatches != 1:
        overrides["microbatches"] = args.microbatches
    report = run(RunSpec(kind="train", arch=args.arch, seed=args.seed,
                         overrides=overrides))
    print(json.dumps(report.metrics, indent=1))
    if not report.ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

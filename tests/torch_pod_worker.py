"""One rank of the gang on ``{pod: 2, data: 2, model: 2}`` (gloo on the CPU,
one thread): every job of ``test_torch_pod_gang.py``, on the reduced f32
configs and the reference's weights, each under a time limit of its own
(:data:`JOB_SECONDS`: a job that hangs fails the rank with its name).

For each :class:`Job` of :data:`JOBS`:

* a train job: ``steps.build_train`` on the rank's grid (its blocks and
  its rows of the global batch over ``(pod, data)``), the weights
  replaced by the reference's, then two steps of the arch's optimizer:
  each step's loss and ``grad_norm``, the collective bytes by mechanism
  of the first, the parameters gathered over the rank's pod after each
  step, the FSDP storage's ``pod_gradsync`` count from the shapes, the
  shape counts of ``tp_allreduce`` and the whole attention's
  ``tp_weights`` (``fsdp_tp``), and the same step traced on ``meta`` as
  this rank of the grid (:func:`repro_torch.launch.dryrun.trace_step`):
  its collective bytes by mechanism and groups;
* a serve job (``fsdp_sp``): a prefill of the rank's rows into a cache
  of ``run.cache`` slots and ``run.decode`` steps fed
  ``torch_sp_worker.decode_tokens``' rows: every step's logits, the
  rank's blocks of the decode state after the last step, the bytes of
  the prefill and of each decode step, and a prefill's and a decode
  step's meta traces' bytes.

    python tests/torch_pod_worker.py RANK WORLD COORDINATOR WORKDIR

``WORKDIR`` holds ``<arch>.params.npz`` (the reference's weights in
checkpoint layout) and ``<tag>.batch.npz`` (a job's global batch); it
receives ``rank{r}.<tag>.npz`` and ``rank{r}.<tag>.json``.
"""
import dataclasses
import json
import signal
import sys
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_flat, params_to_flat
from repro_torch.distributed.context import init_distributed, meta_context
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.steps import build_train, pick_optimizer
from repro_torch.models.model import decode_step, period_len, prefill
from repro_torch.sharding.fsdp import FSDP
from repro_torch.sharding.grid import RankGrid
from repro_torch.sharding.tp import tp_allreduce_bytes, tp_weights_bytes
from repro_torch.train.step import TrainState

import torch_sp_worker as SW

MESH = {"pod": 2, "data": 2, "model": 2}
# the same 8 ranks with the pods folded into the data axis: the pod axis
# is pure data parallelism, so a step there computes the same numbers
FOLDED = {"data": 4, "model": 2}
WORLD = 8
# the global batch: one row a rank of (pod, data); the sequence in blocks
# of 64 under fsdp_sp (at least mamba2's chunk of 32)
B, S = SW.B, SW.S
SEED = 5
JOB_SECONDS = 120
# the reduced llama4 with 3 query heads (one kv head of 64): a model
# extent of 2 does not divide them, so the attention runs whole on every
# rank while wq's 192 columns still split
HEADS = {"llama4-maverick-400b-a17b": dict(n_heads=3, n_kv_heads=1,
                                           d_head=64)}


def config(arch: str, get_reduced):
    """The reduced config of either package, with :data:`HEADS`."""
    cfg = get_reduced(arch)
    return dataclasses.replace(cfg, **HEADS.get(arch, {}))


def mesh_tag(mesh: dict) -> str:
    return "x".join(f"{a}{n}" for a, n in mesh.items())


class Job(NamedTuple):
    arch: str
    layout: str
    kind: str                      # "train" or "serve"
    run: Optional[SW.Run] = None   # a serve job's prefill and decode

    @property
    def tag(self) -> str:
        return f"{self.arch}.{self.layout}.{self.kind}"


JOBS = [
    Job("stablelm-1.6b", "fsdp_tp", "train"),
    Job("mamba2-2.7b", "fsdp_tp", "train"),
    Job("llama4-maverick-400b-a17b", "fsdp_tp", "train"),
    Job("stablelm-1.6b", "fsdp_sp", "train"),
    Job("mamba2-2.7b", "fsdp_sp", "train"),
    Job("granite-3-2b", "fsdp_sp", "serve",
        SW.Run("granite-3-2b", S, False, S + SW.DECODE, mesh=MESH)),
]


def _since(ctx, before):
    return {k: v - before.get(k, 0.0) for k, v in
            ctx.collective_bytes.items() if v - before.get(k, 0.0)}


def _meta_grid(rank: int) -> RankGrid:
    return RankGrid(MESH, meta_context(WORLD, rank))


def _traced_bytes(traced) -> dict:
    return {k: v for k, v in traced["collective_bytes"].items() if v}


def _flat(params, cfg, prefix):
    return {f"{prefix}/{k}": v
            for k, v in params_to_flat(params, period_len(cfg)).items()}


def run_train(ctx, work: Path, job: Job, get_reduced) -> tuple:
    cfg = config(job.arch, get_reduced)
    grid = RankGrid(MESH, ctx)
    fn, (_, rows) = build_train(cfg, B, S, device="cpu", layout=job.layout,
                                grid=grid, seed=SEED)
    fsdp = fn.fsdp
    flat = dict(np.load(work / f"{job.arch}.params.npz"))
    params = fsdp.shard_tree(params_from_flat(flat, cfg, device="cpu"))
    state = TrainState(params, pick_optimizer(cfg).init(params), 0)
    out, info = {}, {"coords": grid.coords, "steps": [],
                     "rows": int(next(iter(rows.values())).shape[0])}
    for i in range(2):
        before = dict(ctx.collective_bytes)
        groups = {m: dict(g) for m, g in ctx.collective_groups.items()}
        state, metrics = fn(state, rows)
        got = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        if i == 0:
            info["bytes"] = _since(ctx, before)
            # the sizes of the groups each mechanism ran over in the step
            info["groups"] = {
                mech: sorted({len(r) for r, v in g.items()
                              if v != groups.get(mech, {}).get(r, 0.0)})
                for mech, g in ctx.collective_groups.items()
                if mech in info["bytes"]}
        info["steps"].append(got)
        out.update(_flat(fsdp.full_tree(state.params), cfg, f"step{i}"))
    info["pod_gradsync_shape"] = fsdp.pod_gradsync_bytes(state.params)
    local = B // grid.group("batch").size
    info["tp_allreduce_shape"] = tp_allreduce_bytes(cfg, local, S, "train",
                                                    2, 4)
    info["tp_weights_shape"] = tp_weights_bytes(cfg, "train", 2, 4)
    traced = trace_step("train", cfg, B, S, layout=job.layout,
                        grid=_meta_grid(ctx.rank))
    info["meta_bytes"] = _traced_bytes(traced)
    info["meta_groups"] = traced["collective_group_sizes"]
    return out, info


def run_serve(ctx, work: Path, job: Job, get_reduced) -> tuple:
    run = job.run
    cfg = config(job.arch, get_reduced)
    grid = RankGrid(MESH, ctx)
    flat = dict(np.load(work / f"{job.arch}.params.npz"))
    full = params_from_flat(flat, cfg, device="cpu")
    fsdp = FSDP(grid, full, job.layout, cfg)
    shards = fsdp.shard_tree(full)
    index, count = grid.batch_block(B)
    per = B // count
    batch = {k: torch.from_numpy(v[index * per:(index + 1) * per]) for k, v
             in np.load(work / f"{job.tag}.batch.npz").items()}
    out, info = {}, {"rows": per}
    before = dict(ctx.collective_bytes)
    logits, state = prefill(shards, cfg, batch, cache_len=run.cache,
                            fsdp=fsdp)
    info["prefill_bytes"] = _since(ctx, before)
    steps, info["decode_bytes"] = [logits], []
    for i, tok in enumerate(SW.decode_tokens(run.arch, run.decode)):
        pos = torch.full((per,), run.seq + i, dtype=torch.int32)
        before = dict(ctx.collective_bytes)
        logits, state = decode_step(
            shards, cfg, state,
            torch.from_numpy(tok[index * per:(index + 1) * per]), pos,
            fsdp=fsdp, cache_len=run.cache)
        info["decode_bytes"].append(_since(ctx, before))
        steps.append(logits)
    out["logits"] = torch.stack(steps).numpy()
    out.update({f"state/{k}": v.numpy() for k, v in state.items()})
    info["meta_prefill_bytes"] = _traced_bytes(trace_step(
        "prefill", cfg, B, run.seq, layout=job.layout,
        grid=_meta_grid(ctx.rank)))
    info["meta_decode_bytes"] = _traced_bytes(trace_step(
        "decode", cfg, B, run.cache, layout=job.layout,
        grid=_meta_grid(ctx.rank)))
    return out, info


def _alarm(signum, frame):
    raise TimeoutError(f"a job ran past {JOB_SECONDS} s")


def main(rank: int, world: int, coordinator: str, work: Path) -> None:
    from repro_torch.configs import get_reduced
    torch.set_num_threads(1)
    signal.signal(signal.SIGALRM, _alarm)
    ctx = init_distributed(world, rank, coordinator, "cpu")
    try:
        for job in JOBS:
            signal.alarm(JOB_SECONDS)
            try:
                runner = run_train if job.kind == "train" else run_serve
                out, info = runner(ctx, work, job, get_reduced)
            except TimeoutError as e:
                raise TimeoutError(f"{job.tag}: {e}") from None
            finally:
                signal.alarm(0)
            np.savez(work / f"rank{rank}.{job.tag}.npz", **out)
            (work / f"rank{rank}.{job.tag}.json").write_text(
                json.dumps(info))
    finally:
        ctx.close()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))

"""The port's data-parallel training (``repro_torch.distributed``), the
counterpart of the reference's ``tests/test_distributed.py``, on the CPU
(gloo, one thread per rank):

* units: row sharding, the analytic all-reduce traffic, the
  ``ShardedBatches`` cursor round trip and the union of the ranks'
  shards, the device and backend rules, ``init_distributed``'s errors,
  and ``loss_count`` equal to the loss's own count;
* world 1 (no process group) bitwise equal to ``train_main``: the loss
  scalars and the final checkpoint key by key;
* a world-2 gang (``python -m repro_torch.launch run train --world_size
  2 --device=cpu``) within rtol/atol 5e-4 of world 1, as in the
  reference, with ``allreduce_bytes_per_step == grad_bytes``;
* the two traps of the global loss, on one world-2 gang that
  ``torch_dist_worker.py`` runs once for the module: reduced
  hubert-xlarge (random per-row masks, so the ranks' counts differ) at
  1 and 2 microbatches against the reference's single-process loss and
  gradients on the same weights and batch, and reduced qwen3-moe
  against the mean of the reference's loss and gradients over each
  rank's half of the rows (its dispatch groups are the ranks' shards).
  Tolerances as in ``test_torch_train.py``: loss rtol 1e-5, gradients
  atol 1e-5, rtol 1e-4 (f32 sums in another order);
* ``agree`` raising on every rank when the ranks resume different steps.
"""
import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data import inputs as JI  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.executor import parse_trailing_report  # noqa: E402
from repro_torch.data.inputs import make_batch  # noqa: E402
from repro_torch.distributed import (DistContext, ShardedBatches,  # noqa: E402
                                     allreduce_bytes_per_step,
                                     dist_train_main, free_port,
                                     init_distributed, shard_rows)
from repro_torch.distributed import context as C  # noqa: E402
from repro_torch.launch.train import _LMDictBatches, train_main  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

from test_torch_campaign_chaos import (ONE_THREAD,  # noqa: E402
                                       assert_same_final_checkpoint,
                                       one_thread)
import torch_dist_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
STEPS, CKPT_EVERY, GLOBAL_BATCH, SEQ = 6, 2, 4, 16
KW = dict(reduced=True, steps=STEPS, batch=GLOBAL_BATCH, seq=SEQ, seed=0,
          log_every=0, device="cpu")
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4


def _env():
    src = str(ROOT / "src")
    path = os.environ.get("PYTHONPATH", "")
    return {**os.environ, **ONE_THREAD,
            "PYTHONPATH": src + (os.pathsep + path if path else "")}


# --------------------------------------------------------------------------
# Units
# --------------------------------------------------------------------------
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "torch"])
def test_shard_rows_contiguous_partition(as_tensor):
    arr = np.arange(8 * 3).reshape(8, 3)
    batch = {"tokens": torch.from_numpy(arr) if as_tensor else arr}
    parts = [np.asarray(shard_rows(batch, r, 4)["tokens"]) for r in range(4)]
    assert all(p.shape == (2, 3) for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts), arr)
    with pytest.raises(ValueError):
        shard_rows(batch, 0, 3)          # 8 rows not divisible by 3


def test_allreduce_bytes_analytic_model():
    gb = 1_000_000
    assert allreduce_bytes_per_step(gb, 1) == 0
    assert allreduce_bytes_per_step(gb, 2) == gb          # 2*(1/2)
    assert allreduce_bytes_per_step(gb, 4) == 1_500_000   # 2*(3/4)


def test_sharded_batches_cursor_round_trip_and_union():
    """Every rank advances the identical global stream: seeking the
    shared cursor replays identical shards, and the ranks' shards put
    together are the world-1 batch."""
    cfg = get_reduced("stablelm-1.6b")
    ctx = init_distributed(1, device="cpu")
    data = ShardedBatches(_LMDictBatches(cfg.vocab, 4, 8, 0, "cpu"), ctx)
    _ = data.next_batch()
    mark = data.cursor()
    want = [data.next_batch()["tokens"] for _ in range(3)]
    data.seek(mark)
    got = [data.next_batch()["tokens"] for _ in range(3)]
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    shards = []
    for rank in range(2):
        view = ShardedBatches(_LMDictBatches(cfg.vocab, 4, 8, 0, "cpu"),
                              DistContext(2, rank, None,
                                          torch.device("cpu"), None))
        view.seek(mark)
        shards.append(view.next_batch()["tokens"])
        assert view.ctx.row_range(4) == (2 * rank, 2 * rank + 2)
    torch.testing.assert_close(torch.cat(shards), want[0], rtol=0, atol=0)


def test_rank_device_and_backend_rules(monkeypatch):
    cpu = torch.device("cpu")
    assert C.rank_device(2, 1, "cpu") == cpu
    assert C.choose_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((1, ["cuda:0", "cuda:0"]), (2, ["cuda:0", "cuda:1"])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        got = [C.rank_device(2, r, d) for r in range(2)
               for d in (None, "cuda")]
        assert [str(g) for g in got[::2]] == want == [str(g)
                                                     for g in got[1::2]]
        # ranks sharing a card take gloo; a card each, nccl
        for d in (None, "cuda"):
            assert C.choose_backend(2, d) == (
                "nccl" if count >= 2 else "gloo")
        # an explicit card is every rank's: gloo however many cards
        assert [str(C.rank_device(2, r, "cuda:0"))
                for r in range(2)] == ["cuda:0", "cuda:0"]
        assert C.choose_backend(2, "cuda:0") == "gloo"
    assert C.rank_device(1, 0, None) == torch.device("cuda")   # world 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            C.rank_device(2, 0, device)


def test_init_distributed_refuses_bad_worlds():
    with pytest.raises(ValueError, match="requires coordinator"):
        init_distributed(2, 0, None, "cpu")
    with pytest.raises(ValueError, match="outside world"):
        init_distributed(2, 2, "127.0.0.1:1", "cpu")
    ctx = init_distributed(1, device="cpu")     # no process group
    assert ctx.backend is None and not torch.distributed.is_initialized()
    g = [torch.ones(3)]
    assert ctx.allreduce_(g) is g and ctx.allreduce_calls == 0
    assert ctx.allgather(5).tolist() == [5]
    assert ctx.agree(7, "x") == 7


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b",
                                  "stablelm-1.6b"])
def test_loss_count_equals_the_loss_count(arch):
    cfg = get_reduced(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = make_batch(cfg, 2, 16, seed=1, device="cpu")
    with torch.no_grad():
        tot, cnt, aux = TM.loss_terms(params, cfg, batch, loss_chunk=6)
        loss = TM.train_loss(params, cfg, batch, loss_chunk=6)
    assert torch.equal(TM.loss_count(cfg, batch), cnt)
    assert torch.equal(loss, tot / cnt.clamp_min(1.0) + aux)


# --------------------------------------------------------------------------
# World 1 bitwise; a world-2 gang against it
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def single(tmp_path_factory):
    ck = tmp_path_factory.mktemp("plain")
    with one_thread():
        res = train_main("stablelm-1.6b", checkpoint_dir=str(ck),
                         checkpoint_every=CKPT_EVERY, checkpoint_async=False,
                         **KW)
    return res, ck


def test_dist_world1_bitwise_equals_single_process(single, tmp_path):
    """The distributed trainer at world 1 (no process group, no
    collective) IS the single-process trainer: identical loss scalars and
    a bitwise-identical final checkpoint."""
    plain, plain_ck = single
    with one_thread():
        dist = dist_train_main("stablelm-1.6b", world_size=1,
                               checkpoint_dir=str(tmp_path / "dist"),
                               checkpoint_every=CKPT_EVERY,
                               checkpoint_async=False, **KW)
    assert dist["dist"]["allreduce_bytes_per_step"] == 0
    assert dist["dist"]["allreduce_calls"] == 0
    assert dist["dist"]["backend"] is None
    assert dist["losses"] == plain["losses"]
    assert_same_final_checkpoint(tmp_path / "dist", plain_ck, step=STEPS)


@pytest.mark.timeout(300)
def test_gang_world2_cli_matches_world1(single, tmp_path):
    """``run train --world_size 2`` self-gangs two rank processes on the
    CPU; rank 0's report carries the gang and each rank's dist section."""
    plain, _ = single
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "run", "train",
         "--world_size=2", "--device=cpu", f"--steps={STEPS}",
         f"--batch={GLOBAL_BATCH}", f"--seq={SEQ}", "--log_every=0"],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    report = parse_trailing_report(proc.stdout)
    assert report["status"] == "succeeded"
    met = report["metrics"]
    dist = met["dist"]
    assert (dist["world_size"], dist["rank"], dist["backend"],
            dist["device"], dist["local_batch"]) == (2, 0, "gloo", "cpu", 2)
    assert dist["allreduce_bytes_per_step"] == dist["grad_bytes"] > 0
    # measured: the gradients and the loss, every step
    assert dist["reduced_bytes_per_step"] == dist["grad_bytes"] + 4
    assert dist["agree_calls"] == 2      # the initial and final parameters
    assert met["gang"]["returncodes"] == [0, 0]
    assert [r["rank"] for r in met["gang"]["ranks"]] == [0, 1]
    np.testing.assert_allclose(met["losses"], plain["losses"], rtol=5e-4,
                               atol=5e-4)


# --------------------------------------------------------------------------
# The global loss's traps, and agree, on one world-2 gang
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JM.init_params(jax.random.PRNGKey(11), jax_reduced(arch))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Inputs for every case, then ``torch_dist_worker.py`` as two rank
    processes; returns their work directory."""
    work = tmp_path_factory.mktemp("gang")
    for case, (arch, _) in W.CASES.items():
        np.savez(work / f"{case}.params.npz", **_flatten(_jax_params(arch)))
    vocab = get_reduced("qwen3-moe-30b-a3b").vocab
    np.save(work / "tokens.npy", np.random.default_rng(4).integers(
        0, vocab, size=(W.B, W.S + 1)).astype(np.int32))
    # rank 0 finds steps 2 and 4, rank 1 only step 2
    with one_thread():
        train_main("stablelm-1.6b", checkpoint_dir=str(work / "ck_r0"),
                   checkpoint_every=2, checkpoint_async=False,
                   **{**KW, "steps": 4})
    shutil.copytree(work / "ck_r0", work / "ck_r1")
    shutil.rmtree(work / "ck_r1" / "step_00000004")
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), coordinator, str(work)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    return work


def _reference(case, work):
    """The reference's loss and gradients: for hubert the single process
    on the whole batch, its microbatches averaged as its step does; for
    the MoE the mean over the ranks' halves."""
    arch, mbs = W.CASES[case]
    jcfg = jax_reduced(arch)
    jparams = _jax_params(arch)
    if jcfg.family == "audio":
        batch = JI.make_batch(jcfg, W.B, W.S, W.BATCH_SEED)
    else:
        toks = np.load(work / "tokens.npy")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        mbs = 2                   # the ranks' halves, one group each
    per = W.B // mbs
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.train_loss(
        p, jcfg, b, remat=True, loss_chunk=W.CHUNK)))
    parts = [vg(jparams, {k: v[i * per:(i + 1) * per]
                          for k, v in batch.items()}) for i in range(mbs)]
    loss = np.mean([float(l) for l, _ in parts])
    grads = {k: np.mean([np.asarray(_flatten(g)[k]) for _, g in parts],
                        axis=0) for k in _flatten(parts[0][1])}
    return loss, grads


@pytest.mark.parametrize("case", list(W.CASES))
def test_world2_matches_reference_global_loss(gang, case):
    got = dict(np.load(gang / f"rank0.{case}.npz"))
    loss, grads = _reference(case, gang)
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=LOSS_RTOL)
    assert {k[len("grad/"):] for k in got if k != "loss"} == set(grads)
    for key, want in grads.items():
        np.testing.assert_allclose(got[f"grad/{key}"], want, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"{case}: {key}")


@pytest.mark.parametrize("case", list(W.CASES))
def test_ranks_hold_the_same_reduced_gradients(gang, case):
    a = dict(np.load(gang / f"rank0.{case}.npz"))
    b = dict(np.load(gang / f"rank1.{case}.npz"))
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_hubert_ranks_see_different_counts():
    """The trap is live: the batch's masks give the ranks' rows different
    counts of scored frames, so a mean of the ranks' own means is not
    the global mean."""
    cfg = get_reduced("hubert-xlarge")
    batch = make_batch(cfg, W.B, W.S, seed=W.BATCH_SEED, device="cpu")
    counts = [float(TM.loss_count(cfg, shard_rows(batch, r, 2)))
              for r in range(2)]
    assert counts[0] != counts[1] and min(counts) > 0


def test_agree_raises_when_ranks_resume_different_steps(gang):
    found = [json.loads((gang / f"rank{r}.agree.json").read_text())
             for r in range(2)]
    assert [f["same"] for f in found] == [{"start_step": 4}] * 2
    for f in found:
        assert "ranks disagree on resumed step: [4, 2]" in f["differ"][
            "error"]

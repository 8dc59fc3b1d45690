"""The port's campaign executor under real preemption: two tiny
``python -m repro_torch.launch run train`` jobs on the CPU, each SIGKILLed
once it has published a checkpoint, each resumed from that checkpoint by
its retry, and each final checkpoint bitwise equal to an uninterrupted
in-process ``train_main`` run (the reference's
``test_campaign_chaos_kill_resume_bitwise_identical``)."""
import contextlib
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import (ChaosSpec, JobState, Orchestrator,  # noqa: E402
                              PersistentVolume, replay_events)
from repro_torch.core.executor import EVENTS_REL  # noqa: E402

from test_torch_campaign_exec import _train_run  # noqa: E402

STEPS, CKPT_EVERY = 6, 2
TRAIN_KW = dict(batch=2, seq=16, log_every=0, device="cpu")
# every training process of these tests, children and oracles, runs on one
# CPU thread: the suite runs files side by side, and a child per job with
# a thread per core would swamp the machine.  A child and its oracle must
# use the same count, since a CPU matmul's sums depend on it.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@contextlib.contextmanager
def one_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def final_checkpoint_tree(ckpt_dir):
    from repro_torch.checkpoint import list_checkpoints, load_checkpoint
    ckpts = list_checkpoints(ckpt_dir)
    assert ckpts, f"no published checkpoints under {ckpt_dir}"
    step, path = ckpts[-1]
    tree, mstep = load_checkpoint(path)
    return tree, int(mstep)


def assert_same_final_checkpoint(got_dir, want_dir, *, step, label=""):
    got, got_step = final_checkpoint_tree(got_dir)
    want, want_step = final_checkpoint_tree(want_dir)
    assert got_step == want_step == step
    assert set(got) == set(want) and len(want) > 0
    for key in sorted(want):   # every leaf: params, opt state, step
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"{label}: {key}")


def reference_run(seed, ckpt_dir, **kw):
    """The uninterrupted in-process oracle of one campaign job."""
    from repro_torch.launch.train import train_main
    with one_thread():
        train_main("stablelm-1.6b", reduced=True, steps=STEPS, seed=seed,
                   checkpoint_dir=str(ckpt_dir),
                   checkpoint_every=CKPT_EVERY, checkpoint_async=False,
                   **TRAIN_KW, **kw)


@pytest.mark.timeout(600)
def test_campaign_chaos_kill_resume_bitwise_identical(tmp_path):
    """End-to-end campaign of tiny train runs under SIGKILL injection:
    every run completes, final params are bitwise identical to an
    uninterrupted in-process run, and the event log replays to a
    consistent terminal state."""
    pvc = PersistentVolume(tmp_path / "campaign")
    orch = Orchestrator(pvc)
    seeds = (0, 1)
    runs = [_train_run(f"chaos{s}", seed=s, steps=STEPS,
                       checkpoint_every=CKPT_EVERY,
                       checkpoint_dir=str(tmp_path / f"ck{s}"), **TRAIN_KW)
            for s in seeds]
    orch.submit_runs(runs)
    chaos = ChaosSpec.sample([r.run_name for r in runs], fraction=1.0,
                             seed=7, after_checkpoints=1)
    assert set(chaos.kill_jobs) == {"chaos0", "chaos1"}
    recs = orch.run_cluster(workers=2, chaos=chaos, attempt_timeout_s=240,
                            worker_env=ONE_THREAD)

    # every run eventually completes, each through a real preemption
    for s in seeds:
        rec = recs[f"chaos{s}"]
        assert rec.state == JobState.SUCCEEDED
        result = json.loads(pvc.read_bytes(f"results/chaos{s}.json"))
        outcomes = [h["outcome"] for h in result["attempt_history"]]
        assert "preempted" in outcomes and outcomes[-1] == "succeeded"
        resumed = result["attempt_history"][-1].get("resumed_from_step")
        assert resumed is not None and resumed >= CKPT_EVERY

    # the event log replays to a consistent terminal state
    state = replay_events(pvc.read_bytes(EVENTS_REL).decode().splitlines())
    assert state["ended"] and state["consistent"], state["violations"]
    assert state["counts"] == {"Succeeded": 2}
    assert all(st["chaos_kills"] >= 1 for st in state["jobs"].values())

    summary = json.loads(pvc.read_bytes("results/_campaign_summary.json"))
    assert summary["preemptions"] >= 2
    assert summary["steps_salvaged_by_resume"] >= 2 * CKPT_EVERY
    assert 0.0 < summary["wall_goodput"] < 1.0

    # bitwise identity vs uninterrupted execution (same seed/config)
    for s in seeds:
        reference_run(s, tmp_path / f"ref{s}")
        assert_same_final_checkpoint(tmp_path / f"ck{s}",
                                     tmp_path / f"ref{s}", step=STEPS,
                                     label=f"seed {s}")

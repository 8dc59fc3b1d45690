"""The port's scheduler-crash recovery with real processes: drive a
campaign of tiny CPU train jobs through ``python -m repro_torch.launch
campaign run`` (that process *is* the scheduler), SIGKILL it once
some jobs have completed, restart it with ``--resume``, and lose nothing
(the reference's
``test_scheduler_sigkill_resume_no_rework_bitwise_identical``, cut from
12 jobs to 6 to keep the file near a minute)."""
import json
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from repro_torch.core import replay_events  # noqa: E402
from repro_torch.core.executor import EVENTS_REL, _src_path  # noqa: E402

from test_torch_campaign_chaos import (CKPT_EVERY, ONE_THREAD,  # noqa: E402
                                       STEPS, TRAIN_KW,
                                       assert_same_final_checkpoint,
                                       reference_run)
from test_torch_campaign_exec import _train_run  # noqa: E402

N_SCHED_RUNS = 6


@pytest.mark.timeout(900)
def test_scheduler_sigkill_resume_no_rework_bitwise_identical(tmp_path):
    """Every run completes, no job that succeeded before the kill is
    ever re-executed, each attempt alive at the kill is adopted or, if
    it died with the scheduler, re-queued once, and every final
    checkpoint is bitwise identical to uninterrupted execution."""
    workdir = tmp_path / "campaign"
    jobs = []
    for s in range(N_SCHED_RUNS):
        spec = _train_run(f"run{s:02d}", seed=s, steps=STEPS,
                          checkpoint_every=CKPT_EVERY,
                          checkpoint_async=False,
                          checkpoint_dir=str(tmp_path / f"ck{s}"),
                          **TRAIN_KW)
        d = spec.to_dict()
        d["resources"] = {"gpus": 0, "cpus": 1, "memory_gb": 2.0}
        jobs.append(d)
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(json.dumps(jobs))

    env = {**os.environ, **ONE_THREAD}      # the children inherit it
    env["PYTHONPATH"] = (_src_path() + os.pathsep
                         + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    argv = [sys.executable, "-m", "repro_torch.launch", "campaign", "run",
            "--jobs", str(jobs_file), "--workdir", str(workdir),
            "--workers", "2"]
    events_path = workdir / "repro-data" / EVENTS_REL

    def read_events():
        if not events_path.exists():
            return []
        out = []
        for ln in events_path.read_text(errors="replace").splitlines():
            try:
                out.append(json.loads(ln))
            except ValueError:
                pass                  # torn trailing line mid-append
        return out

    def succeeded_jobs():
        return {e["job"] for e in read_events()
                if e.get("event") == "succeeded"}

    proc = subprocess.Popen(argv, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 420
        while len(succeeded_jobs()) < 2:
            rc = proc.poll()
            assert rc is None, (
                f"scheduler exited early rc={rc}: "
                f"{proc.stderr.read().decode(errors='replace')[-2000:]}")
            assert time.time() < deadline, "no successes before deadline"
            time.sleep(0.2)
        proc.kill()                   # SIGKILL the scheduler itself
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
    done_before = succeeded_jobs()
    assert len(done_before) >= 2
    # the attempts the dead scheduler left running
    orphans = sorted((name, int(att)) for name, st
                     in replay_events(read_events())["jobs"].items()
                     for att in st["live"])

    res = subprocess.run(argv + ["--resume"], env=env,
                         capture_output=True, timeout=420)
    assert res.returncode == 0, res.stderr.decode(errors="replace")[-2000:]
    out = res.stdout.decode(errors="replace")
    summary = json.loads(out[out.index("{"):])
    assert summary["states"] == {"Succeeded": N_SCHED_RUNS}
    assert summary["resumed"] is True
    assert summary["resumed_done"] >= len(done_before)

    events = read_events()
    # exactly one terminal success per job across scheduler generations —
    # zero completed attempts re-executed
    succ = [e["job"] for e in events if e["event"] == "succeeded"]
    assert len(succ) == N_SCHED_RUNS and len(set(succ)) == N_SCHED_RUNS
    resume_idx = max(i for i, e in enumerate(events)
                     if e["event"] == "campaign_resume")
    for e in events[resume_idx:]:
        if e["event"] == "started":
            assert e["job"] not in done_before, \
                f"completed job {e['job']} was re-executed"
    # every attempt alive at the kill was either adopted or re-queued,
    # exactly once
    recovered = sorted((e["job"], e["attempt"]) for e in events
                       if e["event"] in ("adopted", "orphan_requeued"))
    assert recovered == orphans
    state = replay_events(events)
    assert state["ended"] and state["consistent"], state["violations"]
    assert state["counts"] == {"Succeeded": N_SCHED_RUNS}
    assert state["resumes"] == 1
    assert done_before <= set(succ)

    # bitwise identity of every final checkpoint vs uninterrupted
    # in-process execution of the same spec
    for s in range(N_SCHED_RUNS):
        reference_run(s, tmp_path / f"ref{s}")
        assert_same_final_checkpoint(tmp_path / f"ck{s}",
                                     tmp_path / f"ref{s}", step=STEPS,
                                     label=f"seed {s}")

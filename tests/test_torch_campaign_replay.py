"""The port's campaign executor, against the reference's replay tests.

Replay idempotence and scheduler-crash recovery, hermetically.

Property tests (hypothesis, with the conftest fallback when the real
package is absent) over a *recorded* event log rich in outcomes —
retries, preemptions, timeouts, speculation, and a multi-campaign
append:

* any prefix of the log — including a torn trailing line — replays to a
  consistent state, and the torn line contributes nothing;
* ``replay_events`` is an incremental fold: replaying a prefix, then the
  rest on top of it, equals the one-shot replay for every line-aligned
  split (crash-anywhere ≡ never-crashed).

Plus hermetic scheduler-crash recovery over a handcrafted log with real
orphan pids: a live orphan is re-adopted by pid + start-time identity, a
dead one re-queued, and completed work is never re-executed.
"""
import json
import subprocess
import sys
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from repro_torch.core import (JobState, Orchestrator,  # noqa: E402
                              PersistentVolume, SpeculationSpec,
                              replay_events)
from repro_torch.core.executor import (EVENTS_REL, _pid_alive,  # noqa: E402
                                       _pid_start_time)

from test_torch_campaign_speculation import (FAST, FakeProc,  # noqa: E402
                                             _progress, _train_run,
                                             spec_spawn)


# --------------------------------------------------------------------------
# a recorded log rich in outcomes, reused by every property test
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rich_lines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replay_log")

    # campaign A: a clean run, a crash+retry, a preemption, a timeout
    pvc_a = PersistentVolume(tmp / "a")
    orch_a = Orchestrator(pvc_a)
    orch_a.submit_runs([_train_run(n, seed=i, steps=4) for i, n in
                        enumerate(["plain", "flaky", "preempt", "hang"])])
    plans_a = {("flaky", 1): {"rc": 1, "ticks": 2},
               ("preempt", 1): {"rc": -9, "ticks": 2},
               ("hang", 1): {"ticks": 10_000}}     # killed by the timeout
    orch_a.run_cluster(workers=2, spawn=spec_spawn(plans_a),
                       attempt_timeout_s=0.08, **FAST)

    # campaign B: a straggler race with a speculation win + promotion
    pvc_b = PersistentVolume(tmp / "b")
    orch_b = Orchestrator(pvc_b)
    orch_b.submit_runs([
        _train_run("slow", steps=4, checkpoint_dir=str(tmp / "ck_slow")),
        _train_run("peer1", seed=1, steps=4),
        _train_run("peer2", seed=2, steps=4)])
    orch_b.run_cluster(
        workers=4, spawn=spec_spawn({("slow", 1): {"ticks": 10_000},
                                     ("slow", 2): {"ticks": 3}}),
        speculate=SpeculationSpec(min_runtime_s=0.0, grace=None,
                                  min_peers=1),
        progress_fn=_progress({"slow"}), **FAST)

    lines = (pvc_a.read_bytes(EVENTS_REL).decode().splitlines()
             + pvc_b.read_bytes(EVENTS_REL).decode().splitlines())
    # the recording must actually exercise every outcome family
    kinds = {json.loads(ln)["event"] for ln in lines}
    assert {"attempt_failed", "preempted", "attempt_timeout",
            "timeout_kill", "speculation_win", "speculation_loss",
            "speculation_promote", "campaign_start",
            "campaign_end"} <= kinds
    return lines


@settings(max_examples=60)
@given(k=st.integers(min_value=0, max_value=10_000))
def test_any_prefix_replays_consistent(rich_lines, k):
    k %= len(rich_lines) + 1
    state = replay_events(rich_lines[:k])
    assert state["consistent"], (k, state["violations"])


@settings(max_examples=60)
@given(k=st.integers(min_value=0, max_value=10_000),
       j=st.integers(min_value=0, max_value=500))
def test_torn_trailing_line_contributes_nothing(rich_lines, k, j):
    """A crash mid-append leaves a half-written last line: replay must
    treat it exactly as if the write never happened."""
    k %= len(rich_lines)
    line = rich_lines[k]
    j %= len(line)                      # strictly truncated
    torn_state = replay_events(rich_lines[:k] + [line[:j]])
    assert torn_state["consistent"], torn_state["violations"]
    assert torn_state == replay_events(rich_lines[:k])


@settings(max_examples=60)
@given(k=st.integers(min_value=0, max_value=10_000))
def test_incremental_fold_equals_one_shot(rich_lines, k):
    """replay(A+B) == replay(B, state=replay(A)) for any aligned split —
    the property ``--resume-campaign`` stands on."""
    k %= len(rich_lines) + 1
    prefix_state = replay_events(rich_lines[:k])
    folded = replay_events(rich_lines[k:], state=prefix_state)
    assert folded == replay_events(rich_lines)


def test_replay_then_append_then_replay(rich_lines):
    """Folding in three chunks (crash, resume, crash, resume) equals the
    one-shot replay, and the intermediate state is never mutated."""
    a, b = len(rich_lines) // 3, 2 * len(rich_lines) // 3
    s1 = replay_events(rich_lines[:a])
    s1_snapshot = json.loads(json.dumps(s1, default=str))
    s2 = replay_events(rich_lines[a:b], state=s1)
    s3 = replay_events(rich_lines[b:], state=s2)
    assert s3 == replay_events(rich_lines)
    assert json.loads(json.dumps(s1, default=str)) == s1_snapshot


# --------------------------------------------------------------------------
# crash recovery over a handcrafted log with real orphan pids
# --------------------------------------------------------------------------
def test_pid_identity_guards_against_reuse():
    import os
    pid = os.getpid()
    assert _pid_alive(pid, _pid_start_time(pid))
    assert not _pid_alive(pid, 1)          # right pid, wrong start time
    assert not _pid_alive(2 ** 22 + 11)    # beyond pid_max default


def _report_line(name):
    return json.dumps({"kind": "train", "name": name,
                       "status": "succeeded", "metrics": {}})


def test_resume_adopts_live_orphan_requeues_dead_never_reruns_done(
        tmp_path):
    """Handcrafted crash scene: one job already succeeded, one live
    orphan attempt (a real process that will print its RunReport), one
    orphan whose pid is gone.  ``resume=True`` must keep the first,
    adopt the second, re-queue the third — and re-execute nothing."""
    import dataclasses
    pvc = PersistentVolume(tmp_path / "pvc")
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run(n, seed=i, steps=4) for i, n in
                      enumerate(["done", "alive", "dead"])])
    res = dataclasses.asdict(orch.records["done"].spec.resources)

    # the live orphan: sleeps long enough to be adopted, then reports
    out_p = pvc.path("logs/alive.attempt1.out")
    out_p.parent.mkdir(parents=True, exist_ok=True)
    code = ("import time, sys; time.sleep(1.2); "
            f"print({_report_line('alive')!r})")
    with open(out_p, "wb") as fh:
        orphan = subprocess.Popen([sys.executable, "-c", code],
                                  stdout=fh)
    # the dead orphan: a pid that has already exited (reuse is caught by
    # the start-time identity check even if the OS recycles it)
    gone = subprocess.Popen([sys.executable, "-c", "pass"])
    gone.wait()

    t = time.time() - 5.0
    events = [
        {"event": "campaign_start", "workers": 2, "t": t},
        *({"event": "submitted", "job": n, "priority": 0,
           "kind": "train:stablelm-1.6b", "resources": res, "t": t}
          for n in ("done", "alive", "dead")),
        {"event": "admitted", "job": "done", "attempt": 1,
         "node": "local-0", "t": t},
        {"event": "started", "job": "done", "attempt": 1, "pid": 999,
         "pid_start": 1, "t": t, "ckpt_dir": None},
        {"event": "exited", "job": "done", "attempt": 1,
         "returncode": 0, "wall_s": 2.5, "t": t + 2.5},
        {"event": "succeeded", "job": "done", "attempt": 1,
         "resumed_from_step": None, "t": t + 2.5},
        {"event": "admitted", "job": "alive", "attempt": 1,
         "node": "local-1", "t": t},
        {"event": "started", "job": "alive", "attempt": 1,
         "pid": orphan.pid, "pid_start": _pid_start_time(orphan.pid),
         "t": t, "ckpt_dir": None},
        {"event": "admitted", "job": "dead", "attempt": 1,
         "node": "local-0", "t": t + 3},
        {"event": "started", "job": "dead", "attempt": 1,
         "pid": gone.pid, "pid_start": 12345, "t": t + 3,
         "ckpt_dir": None},
    ]
    ev_path = pvc.path(EVENTS_REL)
    ev_path.parent.mkdir(parents=True, exist_ok=True)
    ev_path.write_text(
        "".join(json.dumps(e) + "\n" for e in events), encoding="utf-8")
    done_result = {"loss": 1.23}
    pvc.stage_json("results/done.json", {
        "job": "done", "state": "Succeeded", "attempts": 1,
        "attempt_history": [{"attempt": 1, "outcome": "succeeded",
                             "wall_s": 2.5, "returncode": 0,
                             "speculative": False}],
        "result": {"status": "succeeded", "metrics": done_result}})

    spawn = spec_spawn({})               # every fresh attempt succeeds
    recs = orch.run_cluster(workers=2, spawn=spawn, resume=True, **FAST)

    assert {n: r.state for n, r in recs.items()} == {
        "done": JobState.SUCCEEDED, "alive": JobState.SUCCEEDED,
        "dead": JobState.SUCCEEDED}
    # completed work untouched, its staged result restored
    assert recs["done"].result["metrics"] == done_result
    spawned = [s["job"] for s in spawn.started]
    assert "done" not in spawned and "alive" not in spawned
    # the live orphan was adopted (attempt count unchanged), the dead
    # one re-ran as attempt 2
    assert recs["alive"].attempts == 1
    assert [s["attempt"] for s in spawn.started if s["job"] == "dead"] \
        == [2]

    lines = pvc.read_bytes(EVENTS_REL).decode().splitlines()
    state = replay_events(lines)
    assert state["consistent"], state["violations"]
    assert state["resumes"] == 1
    assert state["counts"] == {"Succeeded": 3}
    kinds = [json.loads(ln)["event"] for ln in lines]
    assert "adopted" in kinds and "orphan_requeued" in kinds
    # no started event for the completed job after the resume marker
    after = lines[kinds.index("campaign_resume"):]
    assert not any(json.loads(ln).get("job") == "done"
                   and json.loads(ln)["event"] == "started"
                   for ln in after)

    summary = json.loads(pvc.read_bytes("results/_campaign_summary.json"))
    assert summary["resumed"] is True
    assert summary["resumed_done"] == 1
    assert summary["orphans_adopted"] == 1
    assert summary["orphans_requeued"] == 1
    assert orphan.wait(timeout=10) == 0

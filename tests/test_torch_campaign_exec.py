"""The port's campaign executor (``repro_torch.core.executor``), hermetic
half: the reference's executor tests over an injectable fake process
spawn (retry/resume argv semantics, unschedulable fail-fast, durable
event-log replay, the ``campaign status`` CLI, CPU pinning, timeouts and
backoff), run against the port.  The real-process tests are in files of
their own (``test_torch_campaign_chaos.py``, ``..._sched_kill.py``,
``..._salvage.py``, ``..._drain.py``) so that xdist spreads them."""
import json
import os
import signal

import pytest

pytest.importorskip("torch")

from repro_torch.core import (JobSpec, JobState, Orchestrator,  # noqa: E402
                              PersistentVolume, Resources, NodeSpec,
                              replay_events)
from repro_torch.core.executor import (EVENTS_REL,  # noqa: E402
                                       job_run_argv, parse_trailing_report)


# --------------------------------------------------------------------------
# Fake process plumbing: exercise the executor loop without paying a torch
# import per job.
# --------------------------------------------------------------------------
class FakeProc:
    """Looks enough like subprocess.Popen for the executor: returns None
    from poll() for ``ticks`` calls, then writes a RunReport to stdout
    and exits with ``rc``."""

    def __init__(self, job, attempt, stdout_fh, *, rc=0, ticks=2,
                 tracker=None):
        self.job, self.attempt = job, attempt
        self.stdout_fh = stdout_fh
        self.rc, self.ticks = rc, ticks
        self.pid = 4242
        self.tracker = tracker
        if tracker is not None:
            tracker["active"] += 1
            tracker["max"] = max(tracker["max"], tracker["active"])

    def poll(self):
        self.ticks -= 1
        if self.ticks > 0:
            return None
        if self.rc == 0:
            report = {"kind": "train", "name": self.job.name,
                      "status": "succeeded",
                      "metrics": {"resumed_from_step":
                                  2 if self.attempt > 1 else None}}
            self.stdout_fh.write(json.dumps(report, indent=1).encode())
            self.stdout_fh.flush()
        if self.tracker is not None:
            self.tracker["active"] -= 1
            self.tracker = None
        return self.rc

    def send_signal(self, sig):
        self.rc, self.ticks = -sig, 1


def fake_spawn(plan=None, tracker=None):
    """plan: {job_name: [rc, rc, ...]} per attempt (default all 0)."""
    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        rcs = (plan or {}).get(job.name, [])
        rc = rcs[attempt - 1] if attempt <= len(rcs) else 0
        return FakeProc(job, attempt, stdout_fh, rc=rc, tracker=tracker)
    return spawn


def _train_run(name, seed=0, **overrides):
    from repro_torch.api import RunSpec
    return RunSpec(kind="train", arch="stablelm-1.6b", seed=seed, name=name,
                   overrides=overrides)


# hermetic tests want no real retry sleeps and no /proc sampling of the
# fake pid — backoff/telemetry get their own dedicated tests below
FAST = dict(retry_backoff_base_s=0.0, telemetry=False)


# --------------------------------------------------------------------------
# Hermetic executor behaviour
# --------------------------------------------------------------------------
def test_retry_reenters_with_resume_argv(tmp_path):
    """A failed attempt is re-admitted with the retry_env overlay: the
    rebuilt argv carries --resume=true (train's RESUMABLE_KINDS
    contract), and the attempt history records the progression."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("flaky", steps=4)])
    seen_argv = []

    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        seen_argv.append(argv)
        return FakeProc(job, attempt, stdout_fh,
                        rc=1 if attempt == 1 else 0)

    recs = orch.run_cluster(workers=1, spawn=spawn, poll_s=0.001, **FAST)
    assert recs["flaky"].state == JobState.SUCCEEDED
    assert recs["flaky"].attempts == 2
    assert not any("--resume=true" in a for a in seen_argv[0])
    assert any(a == "--resume=true" for a in seen_argv[1])
    result = json.loads(pvc.read_bytes("results/flaky.json"))
    outcomes = [h["outcome"] for h in result["attempt_history"]]
    assert outcomes == ["failed", "succeeded"]
    assert result["attempt_history"][1]["resumed_from_step"] == 2


def test_sigkilled_attempt_is_preempted_and_requeued(tmp_path):
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("victim", steps=4)])
    recs = orch.run_cluster(
        workers=1, poll_s=0.001, **FAST,
        spawn=fake_spawn(plan={"victim": [-int(signal.SIGKILL), 0]}))
    assert recs["victim"].state == JobState.SUCCEEDED
    result = json.loads(pvc.read_bytes("results/victim.json"))
    assert [h["outcome"] for h in result["attempt_history"]] \
        == ["preempted", "succeeded"]
    summary = json.loads(pvc.read_bytes("results/_campaign_summary.json"))
    assert summary["preemptions"] == 1
    assert 0.0 < summary["wall_goodput"] < 1.0
    assert summary["steps_salvaged_by_resume"] == 2


def test_exhausted_retries_reach_failed(tmp_path):
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    run = _train_run("doomed", steps=4)
    job = run.to_job()
    job.retries = 1
    orch.submit(job)
    recs = orch.run_cluster(workers=1, poll_s=0.001, **FAST,
                            spawn=fake_spawn(plan={"doomed": [1, 1]}))
    assert recs["doomed"].state == JobState.FAILED
    assert recs["doomed"].attempts == 2
    state = replay_events(
        pvc.read_bytes(EVENTS_REL).decode().splitlines())
    assert state["jobs"]["doomed"]["state"] == "Failed"
    assert state["consistent"], state["violations"]


def test_unschedulable_job_fails_fast(tmp_path):
    """A request no node can ever satisfy fails before anything runs
    instead of waiting forever."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit(JobSpec(name="whale", resources=Resources(gpus=64),
                        env={"RUN_KIND": "train"}))
    orch.submit_runs([_train_run("minnow", steps=4)])
    recs = orch.run_cluster(
        workers=2, poll_s=0.001, spawn=fake_spawn(), **FAST,
        inventory=[NodeSpec("small", gpus=1, gpu_memory_gb=16, cpus=8,
                            memory_gb=64, count=2)])
    assert recs["whale"].state == JobState.FAILED
    assert "unschedulable" in recs["whale"].error
    assert recs["minnow"].state == JobState.SUCCEEDED


def test_event_log_is_durable_and_replayable(tmp_path):
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run(f"j{i}", seed=i, steps=4)
                      for i in range(4)])
    orch.run_cluster(workers=2, poll_s=0.001, **FAST, spawn=fake_spawn(
        plan={"j1": [-int(signal.SIGKILL), 0]}))
    events_path = pvc.path(EVENTS_REL)
    assert events_path.exists()
    lines = events_path.read_text().splitlines()
    # every line is intact JSON (fsynced append-only)
    parsed = [json.loads(ln) for ln in lines]
    assert parsed[0]["event"] == "campaign_start"
    assert parsed[-1]["event"] == "campaign_end"
    state = replay_events(lines)
    assert state["ended"] and state["consistent"], state["violations"]
    assert state["counts"] == {"Succeeded": 4}
    assert state["jobs"]["j1"]["preemptions"] == 1
    # a half-written trailing line (crash mid-append) is tolerated
    state2 = replay_events(lines + ['{"event": "succ'])
    assert state2["counts"] == {"Succeeded": 4}
    # replay after appending a second campaign keeps only the newest
    orch2 = Orchestrator(pvc)
    orch2.submit_runs([_train_run("solo", steps=4)])
    orch2.run_cluster(workers=1, poll_s=0.001, spawn=fake_spawn(), **FAST)
    state3 = replay_events(events_path.read_text().splitlines())
    assert set(state3["jobs"]) == {"solo"}


def test_campaign_status_cli(tmp_path, capsys):
    from repro_torch.launch.__main__ import main
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("a", steps=4), _train_run("b", steps=4)])
    orch.run_cluster(workers=2, poll_s=0.001, spawn=fake_spawn(), **FAST)
    assert main(["campaign", "status", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Succeeded" in out and "a" in out and "b" in out
    assert main(["campaign", "status", str(tmp_path), "--json"]) == 0
    state = json.loads(capsys.readouterr().out)
    assert state["counts"] == {"Succeeded": 2} and state["consistent"]
    assert main(["campaign", "status", str(tmp_path / "nowhere")]) == 2
    capsys.readouterr()


def test_priority_admission_order(tmp_path):
    """Single-slot pool: admission follows (-priority, submit order)."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    for name, prio in [("low", 0), ("high", 5), ("mid", 2), ("high2", 5)]:
        orch.submit(JobSpec(name=name, priority=prio,
                            env={"RUN_KIND": "train"},
                            resources=Resources(gpus=1, cpus=1,
                                                memory_gb=1)))
    orch.run_cluster(workers=1, poll_s=0.001, spawn=fake_spawn(), **FAST)
    events = [json.loads(ln) for ln
              in pvc.read_bytes(EVENTS_REL).decode().splitlines()]
    admitted = [e["job"] for e in events if e["event"] == "admitted"]
    assert admitted == ["high", "high2", "mid", "low"]


def test_run_local_summary_never_claims_real_makespan(tmp_path):
    """run_local's lane accounting is *simulated*: the field is
    simulated_makespan_s, and the real-wall-clock key (makespan_s, as
    written by run_cluster's _campaign_summary.json) must never appear
    there — BENCH consumers distinguish the two by name."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    for i in range(3):
        orch.submit(JobSpec(name=f"j{i}", payload=lambda **kw: "ok"))
    orch.run_local(parallelism=2)
    summary = json.loads(pvc.read_bytes("results/_local_run_summary.json"))
    assert "simulated_makespan_s" in summary
    assert "makespan_s" not in summary
    assert summary["simulated_makespan_s"] <= summary["serial_s"] + 1e-9


def test_pin_cpus_exports_affinity_per_worker_slot(tmp_path):
    """pin_cpus=True turns the Resources.cpus request into a per-slot
    REPRO_CPU_AFFINITY core list (round-robin over host cores)."""
    if not hasattr(os, "sched_getaffinity"):
        pytest.skip("no sched_getaffinity on this platform")
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    for i in range(4):
        orch.submit(JobSpec(name=f"j{i}", env={"RUN_KIND": "train"},
                            resources=Resources(gpus=0, cpus=1,
                                                memory_gb=1.0)))
    seen = {}

    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        seen[job.name] = env.get("REPRO_CPU_AFFINITY")
        return FakeProc(job, attempt, stdout_fh)

    orch.run_cluster(workers=4, poll_s=0.001, spawn=spawn, pin_cpus=True,
                     **FAST)
    host = sorted(os.sched_getaffinity(0))
    assert len(seen) == 4
    for cores in seen.values():
        assert cores is not None
        parsed = [int(c) for c in cores.split(",")]
        assert len(parsed) == 1 and parsed[0] in host
    # slots cycle round-robin over the host cores
    assert len({seen[f"j{i}"] for i in range(4)}) == min(4, len(host))


def test_parse_trailing_report_skips_step_logs():
    text = ("step     0 loss 10.9 lr 1e-3 gnorm 1.0\n"
            "{'not': 'json'}\n"
            + json.dumps({"status": "succeeded", "kind": "train",
                          "name": "x", "metrics": {}}, indent=1))
    rep = parse_trailing_report(text)
    assert rep and rep["status"] == "succeeded"
    assert parse_trailing_report("no json here") is None


def test_job_run_argv_round_trip():
    from repro_torch.api.spec import RunSpec
    spec = _train_run("rt", seed=3, steps=7, lr=1e-4,
                      checkpoint_dir="/tmp/x")
    argv = job_run_argv(spec.to_job())
    rebuilt = RunSpec.from_args(argv[1:])
    assert rebuilt.kind == "train" and rebuilt.name == "rt"
    assert rebuilt.seed == 3
    assert rebuilt.overrides["steps"] == 7
    assert rebuilt.overrides["lr"] == 1e-4
    assert rebuilt.overrides["checkpoint_dir"] == "/tmp/x"
    argv_resume = job_run_argv(spec.to_job(), resume=True)
    assert RunSpec.from_args(argv_resume[1:]).overrides["resume"] is True


def test_timeout_gets_its_own_outcome_and_requeues(tmp_path):
    """A timed-out attempt is not a generic kill: it gets the 'timeout'
    outcome, its own event, a retry, and its wall counts as lost work."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("slowpoke", steps=4)])

    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        # first attempt hangs until the executor kills it; retry is quick
        return FakeProc(job, attempt, stdout_fh,
                        ticks=10_000 if attempt == 1 else 2)

    recs = orch.run_cluster(workers=1, poll_s=0.001, spawn=spawn,
                            attempt_timeout_s=0.05, **FAST)
    assert recs["slowpoke"].state == JobState.SUCCEEDED
    result = json.loads(pvc.read_bytes("results/slowpoke.json"))
    assert [h["outcome"] for h in result["attempt_history"]] \
        == ["timeout", "succeeded"]
    summary = json.loads(pvc.read_bytes("results/_campaign_summary.json"))
    assert summary["timeouts"] == 1
    assert summary["preemptions"] == 1       # timeouts count as lost work
    assert summary["lost_attempt_wall_s"] > 0
    assert 0.0 < summary["wall_goodput"] < 1.0
    events = [json.loads(ln) for ln
              in pvc.read_bytes(EVENTS_REL).decode().splitlines()]
    assert any(e["event"] == "timeout_kill" for e in events)
    timeout_evs = [e for e in events if e["event"] == "attempt_timeout"]
    assert len(timeout_evs) == 1 and timeout_evs[0]["requeued"] is True
    state = replay_events(events)
    assert state["jobs"]["slowpoke"]["timeouts"] == 1
    assert state["consistent"], state["violations"]


class _TickClock:
    """Injected wall clock: every observation advances time a little, so
    backoff windows pass deterministically without real sleeping."""

    def __init__(self, start=1_000.0, tick=0.01):
        self.t, self.tick = start, tick

    def __call__(self):
        self.t += self.tick
        return self.t


def test_retry_backoff_exponential_jitter_deterministic(tmp_path):
    """Failure retries back off exponentially with full jitter; the
    sequence is a pure function of backoff_seed under an injected clock,
    and the requeued attempt does not start before its gate."""
    def run_once(root):
        pvc = PersistentVolume(root)
        orch = Orchestrator(pvc)
        orch.submit_runs([_train_run("flappy", steps=4)])
        orch.run_cluster(workers=1, poll_s=0.0, telemetry=False,
                         spawn=fake_spawn(plan={"flappy": [1, 1, 0]}),
                         retry_backoff_base_s=4.0, retry_backoff_cap_s=30.0,
                         backoff_seed=7, clock=_TickClock())
        return [json.loads(ln) for ln
                in pvc.read_bytes(EVENTS_REL).decode().splitlines()]

    ev1 = run_once(tmp_path / "a")
    ev2 = run_once(tmp_path / "b")
    backoffs = [e["backoff_s"] for e in ev1
                if e["event"] == "attempt_failed" and e["requeued"]]
    assert backoffs == [e["backoff_s"] for e in ev2
                        if e["event"] == "attempt_failed" and e["requeued"]]
    # full-jitter envelope: base * 2**(nfail-1) * [0.5, 1.0]
    assert len(backoffs) == 2
    assert 2.0 <= backoffs[0] <= 4.0
    assert 4.0 <= backoffs[1] <= 8.0
    # the requeued attempt never starts inside the backoff window
    fails = [e for e in ev1 if e["event"] == "attempt_failed"]
    starts = {e["attempt"]: e for e in ev1 if e["event"] == "started"}
    for nfail, fail in enumerate(fails, start=1):
        nxt = starts.get(fail["attempt"] + 1)
        assert nxt is not None
        assert nxt["t"] >= fail["t"] + fail["backoff_s"] - 1e-6


def test_preemption_requeues_without_backoff(tmp_path):
    """A signal preemption is the cluster's fault, not the job's: the
    resume attempt is admitted immediately (no backoff gate), even with
    backoff configured."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("victim", steps=4)])
    orch.run_cluster(workers=1, poll_s=0.0, telemetry=False,
                     spawn=fake_spawn(
                         plan={"victim": [-int(signal.SIGKILL), 0]}),
                     retry_backoff_base_s=60.0, clock=_TickClock())
    events = [json.loads(ln) for ln
              in pvc.read_bytes(EVENTS_REL).decode().splitlines()]
    pre = next(e for e in events if e["event"] == "preempted")
    assert "backoff_s" not in pre and pre["requeued"] is True
    restart = next(e for e in events if e["event"] == "started"
                   and e["attempt"] == 2)
    assert restart["t"] - pre["t"] < 1.0      # gate would have been 30s+

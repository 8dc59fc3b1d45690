"""The port's campaign executor, gang and utilization half: the
reference's hermetic gang-scheduling tests (``test_distributed.py``, over
the fake spawn: one process per rank sharing a coordinator, whole-gang
kill and requeue when one rank dies, fail-fast unschedulable gangs, the
worker cap in process units, the ``campaign status`` gang row), the
per-rank argv of ``repro_torch.distributed.gang``, and the replayed
utilization ledger (``test_placement.py``).  Real world-2 gangs train in
``test_torch_dist_gang_chaos.py`` and ``test_torch_dist_gang_elastic.py``."""
import json

import pytest

pytest.importorskip("torch")

from repro_torch.core import (JobSpec, JobState, Orchestrator,  # noqa: E402
                              PersistentVolume, Resources, replay_events)
from repro_torch.core.executor import EVENTS_REL, format_status  # noqa: E402
from repro_torch.distributed.gang import rank_argv  # noqa: E402

from test_torch_campaign_exec import (FAST, FakeProc,  # noqa: E402
                                      _train_run, fake_spawn)


def test_rank_argv_appends_dist_flags():
    base = ["python", "-m", "repro_torch.launch", "run", "train", "--steps=3"]
    got = rank_argv(base, 1, "127.0.0.1:555")
    assert got[:len(base)] == base
    assert got[len(base):] == ["--dist_rank=1",
                               "--coordinator=127.0.0.1:555"]
    assert base[-1] == "--steps=3"       # input untouched


def test_world_size_override_becomes_gang():
    from repro_torch.api import RunSpec
    spec = RunSpec(kind="train", arch="stablelm-1.6b", seed=0,
                   name="ddp", overrides={"world_size": 2, "steps": 2})
    assert spec.to_job().gang == 2
    assert RunSpec(kind="train", arch="stablelm-1.6b", seed=0,
                   name="solo").to_job().gang == 1


def _gang_job(name, gang, *, retries=3, cpus=1, priority=0):
    return JobSpec(name=name, gang=gang, retries=retries,
                   priority=priority,
                   resources=Resources(gpus=0, cpus=cpus, memory_gb=1.0),
                   env={"RUN_KIND": "train"})


def test_gang_spawns_one_process_per_rank_shared_coordinator(tmp_path):
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit(_gang_job("ddp", 2))
    seen = []

    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        seen.append(argv)
        return FakeProc(job, attempt, stdout_fh)

    recs = orch.run_cluster(workers=2, poll_s=0.0, telemetry=False,
                            retry_backoff_base_s=0.0, spawn=spawn)
    assert recs["ddp"].state == JobState.SUCCEEDED
    assert len(seen) == 2
    ranks = sorted(a for argv in seen for a in argv
                   if a.startswith("--dist_rank="))
    assert ranks == ["--dist_rank=0", "--dist_rank=1"]
    coords = {a for argv in seen for a in argv
              if a.startswith("--coordinator=")}
    assert len(coords) == 1              # both ranks share one address


def test_gang_rank_death_requeues_whole_gang_and_resumes(tmp_path):
    """One rank dying kills the gang (the survivor is reaped, not
    orphaned), the whole gang is requeued as preempted, and the retry
    attempt re-spawns EVERY rank with the resume overlay."""
    from repro_torch.api import RunSpec
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    # the RunSpec path (not a raw JobSpec): to_job maps world_size to
    # gang AND fills the retry_env resume overlay for train kinds
    orch.submit_runs([RunSpec(
        kind="train", arch="stablelm-1.6b", seed=0, name="ddp",
        overrides={"steps": 4, "world_size": 2,
                   "checkpoint_dir": str(tmp_path / "ck")})])
    attempts = []

    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        rank = next(int(a.split("=")[1]) for a in argv
                    if a.startswith("--dist_rank="))
        attempts.append((attempt, rank, argv))
        import signal as _sig
        rc = -int(_sig.SIGKILL) if (attempt == 1 and rank == 1) else 0
        return FakeProc(job, attempt, stdout_fh, rc=rc)

    recs = orch.run_cluster(workers=2, poll_s=0.0, telemetry=False,
                            retry_backoff_base_s=0.0, spawn=spawn)
    assert recs["ddp"].state == JobState.SUCCEEDED
    assert sorted((a, r) for a, r, _ in attempts) \
        == [(1, 0), (1, 1), (2, 0), (2, 1)]
    for a, _r, argv in attempts:
        assert ("--resume=true" in argv) == (a == 2)
    events = [json.loads(ln) for ln
              in pvc.read_bytes(EVENTS_REL).decode().splitlines()]
    exits = [(e["attempt"], e["rank"], e["returncode"]) for e in events
             if e["event"] == "rank_exited"]
    assert len(exits) == 4               # every rank's exit is logged
    assert any(e["event"] == "preempted" for e in events)
    state = replay_events(events)
    assert state["consistent"], state["violations"]
    assert state["jobs"]["ddp"]["gang"] == 2
    assert state["jobs"]["ddp"]["preemptions"] == 1


def test_unschedulable_gang_fails_fast_without_spawning(tmp_path):
    """A gang that can never be placed — more ranks than worker slots,
    or per-rank requests no inventory satisfies — fails at submit
    validation, before any process starts."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit(_gang_job("too-wide", 4))
    spawned = []

    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        spawned.append(job.name)
        return FakeProc(job, attempt, stdout_fh)

    recs = orch.run_cluster(workers=2, poll_s=0.0, telemetry=False,
                            retry_backoff_base_s=0.0, spawn=spawn)
    assert recs["too-wide"].state == JobState.FAILED
    assert "unschedulable" in recs["too-wide"].error
    assert "gang" in recs["too-wide"].error
    assert spawned == []
    events = [json.loads(ln) for ln
              in pvc.read_bytes(EVENTS_REL).decode().splitlines()]
    assert any(e["event"] == "unschedulable" and e.get("gang") == 4
               for e in events)


def test_gang_counts_against_worker_cap_in_processes(tmp_path):
    """workers=2 with a 2-rank gang plus singletons: never more than 2
    live processes, and everything completes."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit(_gang_job("ddp", 2))
    for i in range(3):
        orch.submit(_gang_job(f"solo{i}", 1))
    tracker = {"active": 0, "max": 0}
    recs = orch.run_cluster(workers=2, poll_s=0.0, telemetry=False,
                            retry_backoff_base_s=0.0,
                            spawn=fake_spawn(tracker=tracker))
    assert tracker["max"] <= 2
    assert all(r.state == JobState.SUCCEEDED for r in recs.values())


def test_status_renders_gang_as_one_row_with_rank_states(tmp_path):
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit(_gang_job("ddp", 2))
    orch.run_cluster(workers=2, poll_s=0.0, telemetry=False,
                     retry_backoff_base_s=0.0, spawn=fake_spawn())
    state = replay_events(pvc.read_bytes(EVENTS_REL).decode()
                          .splitlines())
    st = state["jobs"]["ddp"]
    assert st["gang"] == 2 and st["gang_id"] == "ddp.g1"
    assert {r["returncode"] for r in st["ranks"].values()} == {0}
    text = format_status(state)
    assert sum(ln.startswith("ddp") for ln in text.splitlines()) == 1
    assert "2[0:0 1:0]" in text



# --------------------------------------------------------------------------
# The utilization ledger (the reference's test_placement.py)
# --------------------------------------------------------------------------
def _ev(event, t, **kw):
    return {"event": event, "t": t, **kw}


def test_ledger_handcrafted_log_exact_auc():
    """A two-attempt job on an elastic inventory: attempt 1 (lost) on
    n0, node n1 added mid-window, attempt 2 (succeeded) on n1, n0
    removed before the end.  Every area-under-curve number is checked
    by hand."""
    res = {"gpus": 1, "cpus": 2, "memory_gb": 2.0}
    lines = [
        _ev("campaign_start", 0.0, workers=2,
            inventory=[{"name": "n0", "gpus": 2, "cpus": 4,
                        "memory_gb": 8.0}]),
        _ev("submitted", 0.0, job="jobA", resources=res),
        _ev("admitted", 10.0, job="jobA", attempt=1, node="n0",
            resources=res),
        _ev("node_added", 20.0, node="n1", gpus=2, cpus=4,
            memory_gb=8.0),
        _ev("exited", 30.0, job="jobA", attempt=1, returncode=-9),
        _ev("preempted", 30.0, job="jobA", attempt=1),
        _ev("admitted", 40.0, job="jobA", attempt=2, node="n1",
            resources=res),
        _ev("node_removed", 45.0, node="n0"),
        _ev("exited", 50.0, job="jobA", attempt=2, returncode=0),
        _ev("succeeded", 50.0, job="jobA", attempt=2),
    ]
    state = replay_events(lines)
    assert state["consistent"], state["violations"]
    util = state["utilization"]
    n0, n1 = util["nodes"]["n0"], util["nodes"]["n1"]
    # n0: available 0..45 at 2 gpus; busy 10..30 at 1 gpu, none goodput
    assert n0["available_gpu_s"] == pytest.approx(90.0)
    assert n0["busy_gpu_s"] == pytest.approx(20.0)
    assert n0["goodput_gpu_s"] == pytest.approx(0.0)
    assert n0["busy_gpu_util"] == pytest.approx(20.0 / 90.0, abs=1e-4)
    # n1: available 20..50; busy 40..50, all goodput (attempt 2 won)
    assert n1["available_gpu_s"] == pytest.approx(60.0)
    assert n1["busy_gpu_s"] == pytest.approx(10.0)
    assert n1["goodput_gpu_s"] == pytest.approx(10.0)
    assert n1["goodput_gpu_util"] == pytest.approx(10.0 / 60.0, abs=1e-4)
    # cpu axis accrues with the same windows at the cpu request
    assert n0["busy_cpu_s"] == pytest.approx(40.0)
    assert n1["goodput_cpu_s"] == pytest.approx(20.0)
    cl = util["cluster"]
    assert cl["available_gpu_s"] == pytest.approx(150.0)
    assert cl["busy_gpu_s"] == pytest.approx(30.0)
    assert cl["goodput_gpu_s"] == pytest.approx(10.0)
    assert cl["busy_gpu_util"] == pytest.approx(30.0 / 150.0, abs=1e-4)
    assert cl["goodput_gpu_util"] == pytest.approx(10.0 / 150.0,
                                                   abs=1e-4)
    # recomputing from the same lines is bit-identical (the acceptance
    # criterion behind `--resume-campaign` replay equality)
    assert replay_events(lines)["utilization"] == util
    # and the ledger folds incrementally like every other replay field
    half = replay_events(lines[:5])
    folded = replay_events(lines[5:], state=half)
    assert folded["utilization"] == util


def test_ledger_open_intervals_close_at_newest_event():
    """A still-running attempt contributes busy seconds up to the
    newest event time without mutating the fold state (a later fold
    continues from the same accumulators)."""
    res = {"gpus": 1, "cpus": 1, "memory_gb": 1.0}
    lines = [
        _ev("campaign_start", 0.0, workers=1,
            inventory=[{"name": "n0", "gpus": 1, "cpus": 1,
                        "memory_gb": 4.0}]),
        _ev("submitted", 0.0, job="live", resources=res),
        _ev("admitted", 5.0, job="live", attempt=1, node="n0",
            resources=res),
        _ev("heartbeat", 25.0),
    ]
    state = replay_events(lines)
    row = state["utilization"]["nodes"]["n0"]
    assert row["available_gpu_s"] == pytest.approx(25.0)
    assert row["busy_gpu_s"] == pytest.approx(20.0)   # 5..25 still open
    assert row["goodput_gpu_s"] == pytest.approx(0.0)
    # the open interval was closed virtually: continuing the fold to
    # the real exit accrues from the admission stamp, not the horizon
    done = replay_events(
        [_ev("exited", 45.0, job="live", attempt=1, returncode=0),
         _ev("succeeded", 45.0, job="live", attempt=1)], state=state)
    row = done["utilization"]["nodes"]["n0"]
    assert row["busy_gpu_s"] == pytest.approx(40.0)
    assert row["goodput_gpu_s"] == pytest.approx(40.0)


def test_campaign_summary_utilization_matches_status_replay(tmp_path):
    """The summary's ledger is derived solely from event-log replay, so
    `campaign status --json` over the same log reproduces it exactly;
    the chosen placement policy is stamped on campaign_start and in the
    summary."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run(f"r{i}", steps=2) for i in range(3)])
    orch.run_cluster(workers=2, spawn=fake_spawn(), poll_s=0.001,
                     placement="pack", **FAST)
    summary = json.loads(pvc.read_bytes("results/_campaign_summary.json"))
    assert summary["placement"] == "pack"
    lines = pvc.read_bytes(EVENTS_REL).decode().splitlines()
    state = replay_events(lines)
    assert state["consistent"], state["violations"]
    # the status --json schema: utilization with per-node + cluster AUC
    assert set(state["utilization"]) == {"nodes", "cluster"}
    for row in state["utilization"]["nodes"].values():
        assert {"available_gpu_s", "busy_gpu_s", "goodput_gpu_s",
                "busy_gpu_util", "goodput_gpu_util",
                "available_cpu_s", "busy_cpu_s", "goodput_cpu_s",
                "busy_cpu_util", "goodput_cpu_util"} <= set(row)
    assert summary["utilization"] == state["utilization"]
    # the whole state survives the CLI's json.dumps path
    json.dumps(state, sort_keys=True, default=str)
    start = json.loads(lines[0])
    assert start["event"] == "campaign_start"
    assert start["placement"] == "pack"
    # all work succeeded: every busy second is a goodput second
    cl = state["utilization"]["cluster"]
    assert cl["busy_cpu_s"] == pytest.approx(cl["goodput_cpu_s"])

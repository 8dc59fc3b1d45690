"""The port's campaign executor under the reference's elastic tests.
Elasticity + preemption classes (hermetic: fake subprocesses,
injected clock — no torch, no real signals).

* priority eviction: a high-priority head evicts the lowest-priority
  running attempt (checkpoint + requeue) and the eviction consumes no
  retry budget and triggers no backoff;
* graceful escalation: SIGTERM first, SIGKILL only after the grace
  window (a victim that ignores SIGTERM still dies);
* elastic inventory via the watched nodes.json control file: grow adds
  admittable capacity mid-campaign, shrink drains (no new admissions,
  residents evicted with grace, node removed once empty) and the
  replayed log shows no oversubscription at any point;
* elastic gangs: a requeued gang that no longer fits shrinks its world
  to the largest admissible size >= gang_min and the restart argv
  carries the shrunk world_size.
"""
import json
import signal

import pytest

pytest.importorskip("torch")

from repro_torch.core import (JobState, NodeSpec, Orchestrator,  # noqa: E402
                              PersistentVolume, replay_events)
from repro_torch.core.executor import EVENTS_REL, format_status  # noqa: E402

from test_torch_campaign_exec import (FAST, FakeProc,  # noqa: E402
                                      _TickClock, _train_run)


def _events(pvc):
    return [json.loads(ln) for ln
            in pvc.read_bytes(EVENTS_REL).decode().splitlines()]


def _spawn_ticks(ticks_plan=None, plan=None, tracker=None, on_spawn=None,
                 proc_cls=FakeProc):
    """fake_spawn with per-(job, attempt) tick counts: ticks_plan maps
    job name -> [ticks_attempt1, ticks_attempt2, ...] (default 2)."""
    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        rcs = (plan or {}).get(job.name, [])
        rc = rcs[attempt - 1] if attempt <= len(rcs) else 0
        tks = (ticks_plan or {}).get(job.name, [])
        ticks = tks[attempt - 1] if attempt <= len(tks) else 2
        if on_spawn is not None:
            on_spawn(job, attempt, argv)
        return proc_cls(job, attempt, stdout_fh, rc=rc, ticks=ticks,
                        tracker=tracker)
    return spawn


def _write_nodes(path, specs):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"nodes": specs}))


# sized for exactly ONE default train request (gpus=1, cpus=4, 24GB)
ONE_JOB_NODE = {"name": "w", "gpus": 1, "gpu_memory_gb": 80,
                "cpus": 4, "memory_gb": 24}


# --------------------------------------------------------------------------
# Priority eviction
# --------------------------------------------------------------------------
def test_high_priority_head_evicts_lowest_priority_running(tmp_path):
    """The preempting scheduler class: when the backoff gate releases
    the high-priority head and the pool is full of lower-priority work,
    the head evicts the victim — SIGTERM, requeue with NO retry cost and
    NO backoff — and both jobs finish."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    hi = _train_run("hi", steps=4)
    hi.labels["priority"] = "5"
    lo = _train_run("lo", steps=4)
    orch.submit_runs([hi, lo])
    # retries=0 on the victim: only a FREE requeue lets it run again
    orch.records["lo"].spec.retries = 0
    recs = orch.run_cluster(
        workers=1, poll_s=0.0, telemetry=False, preempt=True,
        clock=_TickClock(tick=0.05),
        retry_backoff_base_s=2.0, backoff_seed=3,
        inventory=[NodeSpec("w", gpus=1, gpu_memory_gb=80, cpus=4,
                            memory_gb=24)],
        # hi fails once -> backs off; lo (600 ticks ~ forever) fills the
        # slot; when hi's gate opens it must evict lo to get back in
        spawn=_spawn_ticks(plan={"hi": [1, 0]},
                           ticks_plan={"lo": [600, 2]}))
    assert recs["hi"].state == JobState.SUCCEEDED
    assert recs["lo"].state == JobState.SUCCEEDED   # retries=0, yet re-ran
    events = _events(pvc)
    ev = next(e for e in events if e["event"] == "evict")
    assert ev["job"] == "lo" and ev["head"] == "hi"
    assert ev["victim_priority"] < ev["head_priority"]
    evd = next(e for e in events if e["event"] == "evicted")
    assert evd["job"] == "lo" and evd["requeued"] is True
    assert evd["signal"] == int(signal.SIGTERM)
    assert "backoff_s" not in evd                   # no backoff on eviction
    # the eviction consumed no retry budget: attempt 2 started anyway
    assert any(e["event"] == "started" and e["job"] == "lo"
               and e["attempt"] == 2 for e in events)
    state = replay_events(events)
    assert state["ended"] and state["consistent"], state["violations"]
    assert state["jobs"]["lo"]["evictions"] == 1
    # summary accounting: evictions counted with preemptions
    summary = json.loads(
        pvc.read_bytes("results/_campaign_summary.json").decode())
    assert summary["evictions"] == 1
    assert summary["preemptions"] >= 1
    # CLI surface: the status table shows the eviction column
    table = format_status(state)
    assert "evict" in table.splitlines()[0]


def test_no_eviction_without_preempt_class(tmp_path):
    """Same scenario, preempt=False: the head waits instead (here the
    victim finishes on its own) and no evict event is ever emitted."""
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    hi = _train_run("hi", steps=4)
    hi.labels["priority"] = "5"
    lo = _train_run("lo", steps=4)
    orch.submit_runs([hi, lo])
    recs = orch.run_cluster(
        workers=1, poll_s=0.0, telemetry=False, preempt=False,
        clock=_TickClock(tick=0.05),
        retry_backoff_base_s=2.0, backoff_seed=3,
        inventory=[NodeSpec("w", gpus=1, gpu_memory_gb=80, cpus=4,
                            memory_gb=24)],
        spawn=_spawn_ticks(plan={"hi": [1, 0]},
                           ticks_plan={"lo": [40, 2]}))
    assert all(r.state == JobState.SUCCEEDED for r in recs.values())
    assert not any(e["event"] in ("evict", "evicted")
                   for e in _events(pvc))


# --------------------------------------------------------------------------
# Graceful escalation
# --------------------------------------------------------------------------
class _StubbornProc(FakeProc):
    """Ignores SIGTERM (a child stuck in an uninterruptible save);
    only SIGKILL takes it down."""

    def send_signal(self, sig):
        if sig == int(signal.SIGKILL):
            super().send_signal(sig)


def test_sigterm_escalates_to_sigkill_after_grace(tmp_path):
    pvc = PersistentVolume(tmp_path)
    orch = Orchestrator(pvc)
    hi = _train_run("hi", steps=4)
    hi.labels["priority"] = "5"
    lo = _train_run("lo", steps=4)
    orch.submit_runs([hi, lo])
    recs = orch.run_cluster(
        workers=1, poll_s=0.0, telemetry=False, preempt=True,
        grace_s=0.5, clock=_TickClock(tick=0.05),
        retry_backoff_base_s=2.0, backoff_seed=3,
        inventory=[NodeSpec("w", gpus=1, gpu_memory_gb=80, cpus=4,
                            memory_gb=24)],
        spawn=_spawn_ticks(plan={"hi": [1, 0]},
                           ticks_plan={"lo": [600, 2]},
                           proc_cls=_StubbornProc))
    assert all(r.state == JobState.SUCCEEDED for r in recs.values())
    events = _events(pvc)
    exp = next(e for e in events if e["event"] == "grace_expired")
    assert exp["job"] == "lo" and exp["reason"] == "evict"
    evd = next(e for e in events if e["event"] == "evicted")
    assert evd["escalated"] is True
    assert evd["signal"] == int(signal.SIGKILL)


# --------------------------------------------------------------------------
# Elastic inventory (nodes.json)
# --------------------------------------------------------------------------
def test_nodes_file_bootstrap_and_grow(tmp_path):
    """The pool bootstraps from campaign/nodes.json; rewriting the file
    mid-campaign adds the new node and later jobs land on it."""
    pvc = PersistentVolume(tmp_path)
    nodes_file = pvc.path("campaign/nodes.json")
    _write_nodes(nodes_file, [ONE_JOB_NODE])
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("a", steps=4), _train_run("b", steps=4)])
    grown = {"done": False}

    def on_spawn(job, attempt, argv):
        if not grown["done"]:           # grow as soon as 'a' occupies w
            grown["done"] = True
            _write_nodes(nodes_file,
                         [ONE_JOB_NODE, {**ONE_JOB_NODE, "name": "x"}])

    tracker = {"active": 0, "max": 0}
    recs = orch.run_cluster(
        workers=2, poll_s=0.0, clock=_TickClock(), **FAST,
        spawn=_spawn_ticks(ticks_plan={"a": [30]}, tracker=tracker,
                           on_spawn=on_spawn))
    assert all(r.state == JobState.SUCCEEDED for r in recs.values())
    events = _events(pvc)
    start = next(e for e in events if e["event"] == "campaign_start")
    assert [n["name"] for n in start["inventory"]] == ["w-000"]
    added = next(e for e in events if e["event"] == "node_added")
    assert added["node"] == "x-000" and added["cpus"] == 4
    # 'b' could only have run concurrently on the grown node
    assert tracker["max"] == 2
    b_admit = next(e for e in events if e["event"] == "admitted"
                   and e["job"] == "b")
    assert b_admit["node"] == "x-000"
    state = replay_events(events)
    assert state["ended"] and state["consistent"], state["violations"]
    assert set(state["nodes"]) == {"w-000", "x-000"}


def test_nodes_file_drain_completes_all_jobs(tmp_path):
    """Shrinking nodes.json drains the removed node: its resident is
    gracefully evicted (free requeue), the node is removed once empty,
    nothing is ever admitted to it again, and every job completes."""
    pvc = PersistentVolume(tmp_path)
    nodes_file = pvc.path("campaign/nodes.json")
    two = [ONE_JOB_NODE, {**ONE_JOB_NODE, "name": "x"}]
    _write_nodes(nodes_file, two)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("a", steps=4), _train_run("b", steps=4)])
    orch.records["b"].spec.retries = 0   # survives only via free requeue
    shrunk = {"n": 0}

    def on_spawn(job, attempt, argv):
        shrunk["n"] += 1
        if shrunk["n"] == 2:            # both running -> drop node x
            _write_nodes(nodes_file, [ONE_JOB_NODE])

    recs = orch.run_cluster(
        workers=2, poll_s=0.0, clock=_TickClock(), **FAST,
        spawn=_spawn_ticks(ticks_plan={"a": [40], "b": [40, 2]},
                           on_spawn=on_spawn))
    assert all(r.state == JobState.SUCCEEDED for r in recs.values())
    events = _events(pvc)
    drain = next(e for e in events if e["event"] == "node_draining")
    assert drain["node"] == "x-000" and drain["residents"] == ["b"]
    evd = next(e for e in events if e["event"] == "evicted")
    assert evd["job"] == "b" and evd["reason"] == "drain"
    removed = next(e for e in events if e["event"] == "node_removed")
    assert removed["node"] == "x-000"
    # no admission to the drained node after the drain line
    drain_i = events.index(drain)
    assert not any(e["event"] == "admitted" and e.get("node") == "x-000"
                   for e in events[drain_i:])
    state = replay_events(events)
    assert state["ended"] and state["consistent"], state["violations"]
    assert set(state["nodes"]) == {"w-000"}
    summary = json.loads(
        pvc.read_bytes("results/_campaign_summary.json").decode())
    assert summary["nodes"]["drained"] == 1
    assert summary["nodes"]["removed"] == 1
    assert [n["name"] for n in summary["nodes"]["final"]] == ["w-000"]


def test_torn_nodes_file_is_ignored_until_valid(tmp_path):
    """A half-written control file must not take down the campaign: the
    rewrite is ignored and retried, and the pool stays intact."""
    pvc = PersistentVolume(tmp_path)
    nodes_file = pvc.path("campaign/nodes.json")
    _write_nodes(nodes_file, [ONE_JOB_NODE])
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("a", steps=4)])

    def on_spawn(job, attempt, argv):
        nodes_file.write_text('{"nodes": [{"name": "w", "cp')  # torn

    recs = orch.run_cluster(workers=1, poll_s=0.0, clock=_TickClock(),
                            **FAST, spawn=_spawn_ticks(on_spawn=on_spawn))
    assert recs["a"].state == JobState.SUCCEEDED
    events = _events(pvc)
    assert not any(e["event"].startswith("node_") for e in events)


# --------------------------------------------------------------------------
# Elastic gangs
# --------------------------------------------------------------------------
def test_gang_shrinks_to_gang_min_after_drain(tmp_path):
    """A 2-rank gang loses a node to a drain; with gang_min=1 it shrinks
    to world=1 instead of failing, and the restart argv carries the
    shrunk --world_size."""
    pvc = PersistentVolume(tmp_path)
    nodes_file = pvc.path("campaign/nodes.json")
    two = [ONE_JOB_NODE, {**ONE_JOB_NODE, "name": "x"}]
    _write_nodes(nodes_file, two)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("g", steps=4, world_size=2, gang_min=1)])
    argvs = {}
    state_holder = {"drained": False}

    def on_spawn(job, attempt, argv):
        argvs.setdefault(attempt, list(argv))
        if not state_holder["drained"]:
            state_holder["drained"] = True
            _write_nodes(nodes_file, [ONE_JOB_NODE])

    recs = orch.run_cluster(
        workers=2, poll_s=0.0, clock=_TickClock(), **FAST,
        spawn=_spawn_ticks(ticks_plan={"g": [40, 40, 2]},
                           on_spawn=on_spawn))
    assert recs["g"].state == JobState.SUCCEEDED
    events = _events(pvc)
    shrunk = next(e for e in events if e["event"] == "gang_shrunk")
    assert shrunk == {**shrunk, "job": "g", "gang_from": 2, "gang_to": 1,
                      "gang_min": 1}
    # the re-placement runs a single process with the shrunk world
    final_attempt = max(argvs)
    assert any(a == "--world_size=1" for a in argvs[final_attempt]), \
        argvs[final_attempt]
    assert not any("--dist_rank" in a for a in argvs[final_attempt])
    state = replay_events(events)
    assert state["ended"] and state["consistent"], state["violations"]
    assert state["jobs"]["g"]["gang"] == 1
    assert state["jobs"]["g"]["gang_shrunk_from"] == 2
    # the status table shows the shrink
    assert "2->1" in format_status(state)


def test_rigid_gang_without_gang_min_fails_unschedulable(tmp_path):
    """gang_min=0 keeps the rigid gang semantics: after a drain leaves
    capacity the gang cannot atomically fit, it is NOT shrunk — the
    requeued gang fails fast as unschedulable (while non-gang work keeps
    running on the surviving node)."""
    pvc = PersistentVolume(tmp_path)
    nodes_file = pvc.path("campaign/nodes.json")
    two = [ONE_JOB_NODE, {**ONE_JOB_NODE, "name": "x"}]
    _write_nodes(nodes_file, two)
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run("g", steps=4, world_size=2)])
    drained = {"done": False}

    def on_spawn(job, attempt, argv):
        if not drained["done"]:
            drained["done"] = True
            _write_nodes(nodes_file, [ONE_JOB_NODE])

    recs = orch.run_cluster(
        workers=2, poll_s=0.0, clock=_TickClock(), **FAST,
        spawn=_spawn_ticks(ticks_plan={"g": [40]}, on_spawn=on_spawn))
    assert recs["g"].state == JobState.FAILED
    assert "unschedulable" in (recs["g"].error or "")
    events = _events(pvc)
    assert not any(e["event"] == "gang_shrunk" for e in events)
    assert any(e["event"] == "unschedulable" and e["job"] == "g"
               for e in events)
    state = replay_events(events)
    assert state["ended"] and state["consistent"], state["violations"]

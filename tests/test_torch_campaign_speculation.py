"""The port's campaign executor under the reference's speculation
tests.  Hermetic speculative-execution tests: straggler detection against an
injected progress probe, first-finisher-wins for both orderings,
checkpoint-dir promotion, and the duplicate-failure no-harm property —
all over fake processes (no torch import, no real training)."""
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.core import (JobState, Orchestrator,  # noqa: E402
                              PersistentVolume, SpeculationSpec,
                              replay_events)
from repro_torch.core.executor import EVENTS_REL  # noqa: E402


class FakeProc:
    """Popen-shaped: poll() returns None ``ticks`` times, then writes a
    RunReport and exits ``rc`` (see tests/test_torch_campaign_exec.py)."""

    def __init__(self, job, attempt, stdout_fh, *, rc=0, ticks=2):
        self.job, self.attempt = job, attempt
        self.stdout_fh = stdout_fh
        self.rc, self.ticks = rc, ticks
        self.pid = 4242

    def poll(self):
        self.ticks -= 1
        if self.ticks > 0:
            return None
        if self.rc == 0:
            report = {"kind": "train", "name": self.job.name,
                      "status": "succeeded", "metrics": {}}
            self.stdout_fh.write(json.dumps(report, indent=1).encode())
            self.stdout_fh.flush()
        return self.rc

    def send_signal(self, sig):
        self.rc, self.ticks = -sig, 1


def spec_spawn(plans):
    """plans: {(job_name, attempt_seq): {"rc":, "ticks":}}.  Every spawn
    materializes its checkpoint dir (from the rebuilt argv) with a
    ``who.txt`` marker, so dir promotion is observable."""
    started = []

    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        plan = plans.get((job.name, attempt), {})
        ck = next((a.split("=", 1)[1] for a in argv
                   if a.startswith("--checkpoint_dir=")), None)
        if ck:
            p = Path(ck)
            p.mkdir(parents=True, exist_ok=True)
            (p / "who.txt").write_text(f"{job.name}:{attempt}")
        started.append({"job": job.name, "attempt": attempt, "ckpt": ck})
        return FakeProc(job, attempt, stdout_fh,
                        rc=plan.get("rc", 0), ticks=plan.get("ticks", 2))
    spawn.started = started
    return spawn


def _train_run(name, seed=0, **overrides):
    from repro_torch.api import RunSpec
    return RunSpec(kind="train", arch="stablelm-1.6b", seed=seed,
                   name=name, overrides=overrides)


# every test injects the progress probe; SPEC makes stragglers eligible
# immediately (no grace gate, single peer suffices)
SPEC = SpeculationSpec(slow_fraction=0.5, min_runtime_s=0.0, grace=None,
                       min_peers=1, max_duplicates_per_job=1)
FAST = dict(retry_backoff_base_s=0.0, telemetry=False, poll_s=0.001)


def _progress(slow_names):
    """Primary attempts of ``slow_names`` crawl; everyone else cruises."""
    def probe(run, now):
        if run.rec.spec.name in slow_names and not run.speculative:
            return 0.05
        return 1.0
    return probe


def _campaign(tmp_path, plans, *, names, ckpt=True, spec=SPEC,
              slow=("slow",), workers=4):
    pvc = PersistentVolume(tmp_path / "pvc")
    orch = Orchestrator(pvc)
    runs = []
    for i, name in enumerate(names):
        kw = {"steps": 4}
        if ckpt:
            kw["checkpoint_dir"] = str(tmp_path / f"ck_{name}")
        runs.append(_train_run(name, seed=i, **kw))
    orch.submit_runs(runs)
    spawn = spec_spawn(plans)
    recs = orch.run_cluster(workers=workers, spawn=spawn, speculate=spec,
                            progress_fn=_progress(set(slow)), **FAST)
    events = [json.loads(ln) for ln
              in pvc.read_bytes(EVENTS_REL).decode().splitlines()]
    summary = json.loads(pvc.read_bytes("results/_campaign_summary.json"))
    return pvc, recs, spawn, events, summary


def test_duplicate_wins_loser_killed_dir_promoted(tmp_path):
    """The straggler's duplicate finishes first: the primary is killed
    and logged as speculation_loss, the duplicate's checkpoint dir is
    promoted onto the declared path, and the job succeeds with its
    primary attempt count untouched."""
    plans = {("slow", 1): {"ticks": 10_000},   # the straggler crawls
             ("slow", 2): {"ticks": 3}}        # its duplicate is healthy
    pvc, recs, spawn, events, summary = _campaign(
        tmp_path, plans, names=["slow", "peer1", "peer2"])

    assert recs["slow"].state == JobState.SUCCEEDED
    assert recs["slow"].attempts == 1          # duplicates are not retries
    dup_started = [s for s in spawn.started
                   if s["job"] == "slow" and s["attempt"] == 2]
    assert len(dup_started) == 1
    assert dup_started[0]["ckpt"].endswith(".spec2")

    by_kind = {}
    for e in events:
        by_kind.setdefault(e["event"], []).append(e)
    assert any(e.get("speculative") for e in by_kind["admitted"])
    assert len(by_kind["speculation_win"]) == 1
    assert len(by_kind["speculation_loss"]) == 1
    assert by_kind["speculation_loss"][0]["wall_s"] >= 0
    promo = by_kind["speculation_promote"][0]
    assert promo["error"] is None

    # the declared dir now holds the winner's artifacts; the loser's are
    # parked, not destroyed
    orig = tmp_path / "ck_slow"
    assert (orig / "who.txt").read_text() == "slow:2"
    assert (orig.parent / "ck_slow.loser" / "who.txt").read_text() \
        == "slow:1"

    assert summary["speculation"] == {
        "launches": 1, "wins": 1, "losses": 1,
        "loss_wall_s": summary["speculation"]["loss_wall_s"]}
    assert summary["speculation"]["loss_wall_s"] > 0

    state = replay_events(events)
    st = state["jobs"]["slow"]
    assert st["speculative_launches"] == 1
    assert st["speculation_losses"] == 1
    assert st["promoted"] is True
    assert state["consistent"], state["violations"]


def test_primary_wins_duplicate_is_the_loser(tmp_path):
    """The slow-but-alive primary beats its duplicate: the duplicate is
    killed as speculation_loss and the declared checkpoint dir is left
    exactly as the primary wrote it (bitwise no-op)."""
    plans = {("slowpoke", 1): {"ticks": 8},        # finishes on its own
             ("slowpoke", 2): {"ticks": 10_000}}   # duplicate never will
    pvc, recs, spawn, events, summary = _campaign(
        tmp_path, plans, names=["slowpoke", "peer1", "peer2"],
        slow=("slowpoke",))

    assert recs["slowpoke"].state == JobState.SUCCEEDED
    kinds = [e["event"] for e in events]
    assert "speculation_win" not in kinds      # the primary won its race
    assert "speculation_promote" not in kinds
    assert sum(1 for e in events
               if e["event"] == "speculation_loss") == 1
    assert (tmp_path / "ck_slowpoke" / "who.txt").read_text() \
        == "slowpoke:1"
    assert not (tmp_path / "ck_slowpoke.loser").exists()
    assert summary["speculation"]["launches"] == 1
    assert summary["speculation"]["wins"] == 0
    state = replay_events(events)
    assert state["jobs"]["slowpoke"]["promoted"] is False
    assert state["consistent"], state["violations"]


def test_failed_duplicate_never_harms_the_job(tmp_path):
    """A duplicate that crashes on its own is just a speculation loss:
    no retry consumed, no requeue, the primary carries on to success."""
    plans = {("slow", 1): {"ticks": 12},
             ("slow", 2): {"rc": 1, "ticks": 2}}   # duplicate crashes
    pvc, recs, spawn, events, summary = _campaign(
        tmp_path, plans, names=["slow", "peer1", "peer2"])

    assert recs["slow"].state == JobState.SUCCEEDED
    assert recs["slow"].attempts == 1
    losses = [e for e in events if e["event"] == "speculation_loss"]
    assert len(losses) == 1 and losses[0]["reason"] == "failed"
    assert not any(e["event"] == "attempt_failed" for e in events)
    result = json.loads(pvc.read_bytes("results/slow.json"))
    outcomes = sorted(h["outcome"] for h in result["attempt_history"])
    assert outcomes == ["speculation_loss", "succeeded"]
    state = replay_events(events)
    assert state["consistent"], state["violations"]


def test_failed_primary_hands_off_to_live_duplicate(tmp_path):
    """The primary dies while its duplicate is racing: the duplicate is
    promoted to primary (no requeue — the race already restarted the
    work) and its dir is promoted on success."""
    plans = {("slow", 1): {"rc": 1, "ticks": 6},   # primary will crash
             ("slow", 2): {"ticks": 20}}           # duplicate outlives it
    pvc, recs, spawn, events, summary = _campaign(
        tmp_path, plans, names=["slow", "peer1", "peer2"])

    assert recs["slow"].state == JobState.SUCCEEDED
    fails = [e for e in events if e["event"] == "attempt_failed"]
    assert len(fails) == 1 and fails[0]["duplicate_continues"] is True
    assert fails[0]["requeued"] is False
    # only two attempts ever spawned: the duplicate was the retry
    assert [s["attempt"] for s in spawn.started
            if s["job"] == "slow"] == [1, 2]
    assert (tmp_path / "ck_slow" / "who.txt").read_text() == "slow:2"
    state = replay_events(events)
    assert state["jobs"]["slow"]["state"] == "Succeeded"
    assert state["consistent"], state["violations"]


def test_speculation_opt_out_and_capacity_respect(tmp_path):
    """A job with speculation=False never gets duplicates, and with no
    spare worker slot nothing speculates at all."""
    pvc = PersistentVolume(tmp_path / "pvc")
    orch = Orchestrator(pvc)
    runs = [_train_run("slow", steps=4), _train_run("peer", seed=1,
                                                    steps=4)]
    orch.submit_runs(runs)
    orch.records["slow"].spec.speculation = False
    spawn = spec_spawn({("slow", 1): {"ticks": 12}})
    orch.run_cluster(workers=4, spawn=spawn, speculate=SPEC,
                     progress_fn=_progress({"slow"}), **FAST)
    assert [s["attempt"] for s in spawn.started
            if s["job"] == "slow"] == [1]

    # saturated workers: an eligible straggler still gets no duplicate
    pvc2 = PersistentVolume(tmp_path / "pvc2")
    orch2 = Orchestrator(pvc2)
    orch2.submit_runs([_train_run("slow", steps=4),
                       _train_run("peer", seed=1, steps=4)])
    spawn2 = spec_spawn({("slow", 1): {"ticks": 12}})
    orch2.run_cluster(workers=2, spawn=spawn2, speculate=SPEC,
                      progress_fn=_progress({"slow"}), **FAST)
    assert all(not s["ckpt"] or ".spec" not in s["ckpt"]
               for s in spawn2.started)
    summary2 = json.loads(
        pvc2.read_bytes("results/_campaign_summary.json"))
    assert summary2["speculation"]["launches"] == 0

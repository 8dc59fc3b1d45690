"""A node drained mid-campaign under the port's executor, with real
processes: a ``nodes.json`` shrink evicts the drained node's resident
with a grace window (its SIGTERM handler salvages a checkpoint), the job
is requeued at no retry cost, every job completes, the replayed log shows
no oversubscription, and every final checkpoint is bitwise identical to
its uninterrupted oracle (the reference's
``test_drain_midcampaign_completes_all_jobs_bitwise``).

The reference triggers the shrink from a thread that polls for
checkpoints under a 300 s deadline.  Here the shrink is written from the
executor's own poll loop, by a spawn wrapper, as soon as a child has
published a checkpoint: no deadline, no race with the wall clock.  The
children stall each step (``REPRO_STEP_DELAY_S``, no change to the math)
so that both nodes are still busy when it fires."""
import json

import pytest

pytest.importorskip("torch")

from repro_torch.core import (JobState, Orchestrator,  # noqa: E402
                              PersistentVolume, replay_events)
from repro_torch.core.executor import (EVENTS_REL,  # noqa: E402
                                       _default_spawn,
                                       _published_checkpoints)

from test_torch_campaign_chaos import (CKPT_EVERY, ONE_THREAD,  # noqa: E402
                                       STEPS, TRAIN_KW,
                                       assert_same_final_checkpoint,
                                       reference_run)
from test_torch_campaign_exec import _train_run  # noqa: E402

# sized for exactly ONE default train request (gpus=1, cpus=4, 24GB)
ONE_JOB_NODE = {"name": "w", "gpus": 1, "gpu_memory_gb": 80,
                "cpus": 4, "memory_gb": 24}


def _write_nodes(path, specs):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"nodes": specs}))
    tmp.replace(path)


class _DrainOnCheckpoint:
    """Popen-shaped wrapper: each poll first checks whether any job has
    published a checkpoint, and if so rewrites nodes.json once."""

    def __init__(self, proc, trigger):
        self.proc, self.trigger = proc, trigger
        self.pid = proc.pid

    def poll(self):
        self.trigger()
        return self.proc.poll()

    def send_signal(self, sig):
        self.proc.send_signal(sig)


@pytest.mark.timeout(900)
def test_drain_midcampaign_completes_all_jobs_bitwise(tmp_path):
    pvc = PersistentVolume(tmp_path / "camp")
    nodes_file = pvc.path("campaign/nodes.json")
    _write_nodes(nodes_file, [ONE_JOB_NODE,
                              {**ONE_JOB_NODE, "name": "x"}])
    seeds = (0, 1, 2)
    runs = [_train_run(f"el{s}", seed=s, steps=STEPS,
                       checkpoint_every=CKPT_EVERY,
                       checkpoint_dir=str(tmp_path / f"ck{s}"), **TRAIN_KW)
            for s in seeds]
    orch = Orchestrator(pvc)
    orch.submit_runs(runs)
    drained = []

    def trigger():
        if not drained and any(_published_checkpoints(
                str(tmp_path / f"ck{s}")) for s in seeds):
            drained.append(True)
            _write_nodes(nodes_file, [ONE_JOB_NODE])

    def spawn(job, attempt, argv, env, stdout, stderr):
        return _DrainOnCheckpoint(
            _default_spawn(job, attempt, argv, env, stdout, stderr),
            trigger)

    slow = {"REPRO_STEP_DELAY_S": "0.5"}
    recs = orch.run_cluster(workers=2, retry_backoff_base_s=0.0,
                            telemetry=False, grace_s=60.0,
                            attempt_timeout_s=300, spawn=spawn,
                            worker_env=ONE_THREAD,
                            straggler_env={r.run_name: slow for r in runs})
    assert drained
    assert all(recs[f"el{s}"].state == JobState.SUCCEEDED for s in seeds)
    events = [json.loads(ln) for ln
              in pvc.read_bytes(EVENTS_REL).decode().splitlines()]
    drain = next(e for e in events if e["event"] == "node_draining")
    assert drain["node"] == "x-000" and drain["residents"]
    assert any(e["event"] == "evicted" and e["reason"] == "drain"
               for e in events)
    assert any(e["event"] == "node_removed" for e in events)
    state = replay_events(events)
    assert state["ended"] and state["consistent"], state["violations"]
    assert set(state["nodes"]) == {"w-000"}
    summary = json.loads(
        pvc.read_bytes("results/_campaign_summary.json").decode())
    assert summary["evictions"] >= 1
    for s in seeds:
        reference_run(s, tmp_path / f"ref{s}")
        assert_same_final_checkpoint(tmp_path / f"ck{s}",
                                     tmp_path / f"ref{s}", step=STEPS,
                                     label=f"seed {s}")

"""An elastic world-2 gang through the port's campaign executor, with
real processes on the CPU (gloo, one thread per rank): the port of the
reference's ``test_campaign_elastic.py::
test_gang_shrink_world2_to_1_matches_world1_losses``.

The gang (``gang_min=1``) spans two one-job nodes.  The shrink of the
inventory to one node is written from the executor's own poll loop, by a
spawn wrapper, as soon as the gang has published a checkpoint: no
wall-clock deadline (the reference's thread polls under one).  The drain
ends the gang, which cannot fit whole any more and shrinks to world 1;
that single process resumes from the shared, rank-agnostic checkpoint,
and its losses continue world 1's within rtol/atol 5e-4, as in the
reference.  Each step stalls 0.25 s (``REPRO_STEP_DELAY_S``, no change to
the math) so that the drain lands while the gang trains."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import (JobState, Orchestrator,  # noqa: E402
                              PersistentVolume, replay_events)
from repro_torch.core.executor import (_default_spawn,  # noqa: E402
                                       _published_checkpoints)

from test_torch_campaign_chaos import ONE_THREAD, one_thread  # noqa: E402
from test_torch_campaign_drain import (ONE_JOB_NODE,  # noqa: E402
                                       _DrainOnCheckpoint, _write_nodes)
from test_torch_campaign_elastic import _events  # noqa: E402
from test_torch_campaign_exec import _train_run  # noqa: E402


@pytest.mark.timeout(600)
def test_gang_shrink_world2_to_1_matches_world1_losses(tmp_path):
    from repro_torch.checkpoint import list_checkpoints
    from repro_torch.distributed import dist_train_main

    steps, ckpt_every, global_batch, seq = 12, 2, 4, 16
    with one_thread():
        ref = dist_train_main("stablelm-1.6b", world_size=1, reduced=True,
                              steps=steps, batch=global_batch, seq=seq,
                              seed=0, log_every=0, device="cpu")

    pvc = PersistentVolume(tmp_path / "camp")
    nodes_file = pvc.path("campaign/nodes.json")
    _write_nodes(nodes_file, [ONE_JOB_NODE, {**ONE_JOB_NODE, "name": "x"}])
    ck = tmp_path / "ck"
    orch = Orchestrator(pvc)
    orch.submit_runs([_train_run(
        "elastic-gang", steps=steps, batch=global_batch, seq=seq,
        world_size=2, gang_min=1, log_every=0, checkpoint_every=ckpt_every,
        checkpoint_dir=str(ck), device="cpu")])
    shrunk_inventory = []

    def trigger():
        if not shrunk_inventory and _published_checkpoints(str(ck)):
            shrunk_inventory.append(True)
            _write_nodes(nodes_file, [ONE_JOB_NODE])

    def spawn(job, attempt, argv, env, stdout, stderr):
        return _DrainOnCheckpoint(
            _default_spawn(job, attempt, argv, env, stdout, stderr),
            trigger)

    recs = orch.run_cluster(
        workers=2, retry_backoff_base_s=0.0, telemetry=False, grace_s=60.0,
        attempt_timeout_s=240, spawn=spawn,
        worker_env={**ONE_THREAD, "REPRO_STEP_DELAY_S": "0.25"})
    assert shrunk_inventory
    assert recs["elastic-gang"].state == JobState.SUCCEEDED
    events = _events(pvc)
    shrunk = next(e for e in events if e["event"] == "gang_shrunk")
    assert shrunk["gang_from"] == 2 and shrunk["gang_to"] == 1
    state = replay_events(events)
    assert state["ended"] and state["consistent"], state["violations"]
    st = state["jobs"]["elastic-gang"]
    assert st["gang"] == 1 and st["gang_shrunk_from"] == 2
    # the final (world-1) attempt resumed from the shared checkpoint and
    # its losses continue the world-1 trajectory
    metrics = recs["elastic-gang"].result["metrics"]
    assert metrics["resumed_from_step"] is not None
    assert "dist" not in metrics            # the single process
    got = metrics["losses"]
    assert 0 < len(got) < steps
    np.testing.assert_allclose(got, ref["losses"][-len(got):],
                               rtol=5e-4, atol=5e-4)
    assert list_checkpoints(ck)[-1][0] == steps

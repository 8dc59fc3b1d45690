"""World-2 data-parallel gangs through the port's campaign executor, with
real processes on the CPU (gloo, one thread per rank): the port of the
reference's ``test_distributed.py::
test_gang_world2_oracle_and_chaos_resume_bitwise``.

1. An undisturbed gang reproduces world 1's losses at the same global
   batch within rtol/atol 5e-4 (the order of the f32 sums is the only
   difference), with ``allreduce_bytes_per_step == grad_bytes``.
2. The same gang with chaos (one rank SIGKILLed once a checkpoint is
   published) is requeued as a whole, resumes from the shared
   checkpoint and ends with a final checkpoint bitwise equal to the
   undisturbed gang's: the same ranks sum the same rows in the same
   order.  Its steps stall 0.25 s each (``REPRO_STEP_DELAY_S``, no change
   to the math) so that the kill lands while the gang trains."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import (ChaosSpec, JobState, Orchestrator,  # noqa: E402
                              PersistentVolume, replay_events)
from repro_torch.core.executor import EVENTS_REL, format_status  # noqa: E402

from test_torch_campaign_chaos import (ONE_THREAD,  # noqa: E402
                                       assert_same_final_checkpoint,
                                       one_thread)
from test_torch_campaign_exec import _train_run  # noqa: E402

STEPS, CKPT_EVERY, GLOBAL_BATCH, SEQ = 6, 2, 4, 16
GANG_KW = dict(steps=STEPS, batch=GLOBAL_BATCH, seq=SEQ, world_size=2,
               log_every=0, checkpoint_every=CKPT_EVERY, device="cpu")


@pytest.mark.timeout(600)
def test_gang_world2_oracle_and_chaos_resume_bitwise(tmp_path):
    from repro_torch.distributed import dist_train_main

    with one_thread():
        ref = dist_train_main("stablelm-1.6b", world_size=1, reduced=True,
                              steps=STEPS, batch=GLOBAL_BATCH, seq=SEQ,
                              seed=0, log_every=0, device="cpu")

    # ---- leg 1: undisturbed gang campaign -> tolerance oracle
    orch = Orchestrator(PersistentVolume(tmp_path / "campA"))
    orch.submit_runs([_train_run("ddp-a", checkpoint_dir=str(
        tmp_path / "ckA"), **GANG_KW)])
    recs = orch.run_cluster(workers=2, retry_backoff_base_s=0.0,
                            telemetry=False, worker_env=ONE_THREAD,
                            attempt_timeout_s=240)
    assert recs["ddp-a"].state == JobState.SUCCEEDED
    metrics = recs["ddp-a"].result["metrics"]
    dist = metrics["dist"]
    assert (dist["world_size"], dist["backend"], dist["device"]) == (
        2, "gloo", "cpu")
    assert dist["allreduce_bytes_per_step"] == dist["grad_bytes"]
    np.testing.assert_allclose(metrics["losses"], ref["losses"],
                               rtol=5e-4, atol=5e-4)

    # ---- leg 2: chaos kills one rank; the gang's resume is bitwise
    pvc_b = PersistentVolume(tmp_path / "campB")
    orch_b = Orchestrator(pvc_b)
    orch_b.submit_runs([_train_run("ddp-b", checkpoint_dir=str(
        tmp_path / "ckB"), **GANG_KW)])
    recs_b = orch_b.run_cluster(
        workers=2, retry_backoff_base_s=0.0, telemetry=False,
        attempt_timeout_s=240,
        worker_env={**ONE_THREAD, "REPRO_STEP_DELAY_S": "0.25"},
        chaos=ChaosSpec(kill_jobs=("ddp-b",), after_checkpoints=1))
    assert recs_b["ddp-b"].state == JobState.SUCCEEDED
    events = [json.loads(ln) for ln
              in pvc_b.read_bytes(EVENTS_REL).decode().splitlines()]
    kills = [e for e in events if e["event"] == "chaos_kill"]
    assert kills and all(e["rank"] == 1 for e in kills)
    state = replay_events(events)
    assert state["consistent"], state["violations"]
    st = state["jobs"]["ddp-b"]
    assert st["gang"] == 2 and st["preemptions"] >= 1
    assert "ddp-b" in format_status(state)
    assert recs_b["ddp-b"].result["metrics"]["resumed_from_step"] \
        is not None
    assert_same_final_checkpoint(tmp_path / "ckB", tmp_path / "ckA",
                                 step=STEPS, label="chaos gang")

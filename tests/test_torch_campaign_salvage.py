"""SIGTERM salvage through the port's ``run train`` CLI, the path the
campaign executor's graceful kills (evictions, drains, speculation
losers) rely on: a real subprocess SIGTERMed mid-run publishes a final
atomic checkpoint at the completed step, dies with rc = -SIGTERM, and the
resumed run lands bitwise on an uninterrupted oracle (the reference's
``test_sigterm_salvage_checkpoint_and_bitwise_resume``)."""
import os
import signal
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.core.executor import _src_path  # noqa: E402

from test_torch_campaign_chaos import (ONE_THREAD,  # noqa: E402
                                       assert_same_final_checkpoint,
                                       one_thread)


def subproc_env(step_delay_s=None):
    env = {**os.environ, **ONE_THREAD}
    if step_delay_s is not None:
        # stalls each step on the wall clock without touching the math
        # (TrainLoop's straggler hook), so the signal lands mid-run
        env["REPRO_STEP_DELAY_S"] = str(step_delay_s)
    src = _src_path()
    existing = env.get("PYTHONPATH", "")
    if src not in existing.split(os.pathsep):
        env["PYTHONPATH"] = src + os.pathsep + existing if existing else src
    return env


@pytest.mark.timeout(600)
def test_sigterm_salvage_checkpoint_and_bitwise_resume(tmp_path):
    """With NO cadence checkpoint to fall back on, the salvage is the
    checkpoint; at most the one in-flight step is lost."""
    from repro_torch.checkpoint import list_checkpoints, read_manifest
    from repro_torch.launch.train import train_main

    ck = tmp_path / "ck"
    steps = 8
    argv = [sys.executable, "-m", "repro_torch.launch", "run", "train",
            "--arch", "stablelm-1.6b", "--seed", "0", "--name", "victim",
            f"--steps={steps}", "--batch=2", "--seq=16", "--log_every=1",
            "--device=cpu",
            "--checkpoint_every=1000",      # cadence NEVER fires
            f"--checkpoint_dir={ck}"]
    proc = subprocess.Popen(argv, env=subproc_env(step_delay_s=0.25),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    # wait for two completed steps, then preempt between steps
    seen = []
    while len(seen) < 2:
        line = proc.stdout.readline()
        assert line, "train subprocess exited before producing steps"
        if line.startswith("step "):
            seen.append(int(line.split()[1]))
    proc.send_signal(signal.SIGTERM)
    rest, _ = proc.communicate(timeout=300)
    assert proc.returncode == -signal.SIGTERM   # preemption, not success
    last_step = max(seen + [int(ln.split()[1]) for ln in rest.splitlines()
                            if ln.startswith("step ")])
    ckpts = list_checkpoints(ck)
    assert len(ckpts) >= 1                 # the salvage IS the checkpoint
    salvage_step, salvage_path = ckpts[-1]
    meta = read_manifest(salvage_path).get("metadata", {})
    assert meta.get("sigterm") is True
    assert "data_cursor" in meta
    # <=1 step lost: saved exactly at the last completed (0-based) step
    assert salvage_step == last_step + 1
    assert salvage_step < steps

    res = subprocess.run(argv + ["--resume=true"], env=subproc_env(),
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]

    with one_thread():
        train_main("stablelm-1.6b", reduced=True, steps=steps, seed=0,
                   batch=2, seq=16, log_every=0, checkpoint_async=False,
                   checkpoint_dir=str(tmp_path / "oracle"), device="cpu")
    assert_same_final_checkpoint(ck, tmp_path / "oracle", step=steps)

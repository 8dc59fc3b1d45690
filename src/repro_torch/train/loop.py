"""Durable training loop: step execution, metrics and throughput
accounting, checkpoint and resume (port of ``repro.train.loop``).

:class:`TrainLoop` owns

* step execution over a *seekable* data source (anything exposing
  ``next_batch()/cursor()/seek(cursor)``, see
  :class:`repro_torch.data.tokens.SeekableTokenBatches`),
* metrics and throughput accounting (pure step time apart from
  checkpoint overhead),
* a :class:`repro_torch.checkpoint.CheckpointManager` for atomic cadence
  checkpoints of the **full** :class:`~repro_torch.train.TrainState` plus
  the data cursor,
* resume (``resume()`` restores state, step and data position from the
  newest valid checkpoint, falling back past torn ones),
* an injectable fault hook (``preempt_at_step=k`` raises
  :class:`Preemption` before executing step ``k``).

The fault hook only fires on runs that did not resume: a resumed attempt
re-crossing the same step must not re-preempt.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint.manager import CheckpointManager


class Preemption(RuntimeError):
    """An injected mid-run kill (the SIGTERM a cluster preemption
    delivers).  Pending checkpoint writes are flushed first."""


class TrainLoop:
    """Reusable step loop with durable checkpoint/resume.

    Parameters
    ----------
    step_fn:    ``(state, batch) -> (state, metrics)``.
    state:      initial :class:`repro_torch.train.TrainState` (anything
                with a ``step`` field holding the completed-step count).
    data:       seekable batch source (``next_batch/cursor/seek``).
    checkpointer: optional :class:`CheckpointManager`; cadence comes from
                the manager (``every_steps``/``every_s``).
    preempt_at_step: fault hook — raise :class:`Preemption` when about to
                execute this (0-based) step, unless the run resumed.
    fault_hook: called with the step index before each step; raise to
                inject any fault.
    log_every:  print a metrics line every N steps (0 disables).
    sigterm_save: install a SIGTERM handler for the duration of ``run``
                that finishes the in-flight step, writes a final atomic
                checkpoint (state + data cursor), then re-raises SIGTERM
                with the default handler so the process still dies with
                the preemption signal (rc = -SIGTERM).  Only effective with
                a checkpointer, from the main thread.
    """

    def __init__(self, step_fn: Callable, state, data, *,
                 checkpointer: Optional[CheckpointManager] = None,
                 preempt_at_step: Optional[int] = None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 log_every: int = 10,
                 sigterm_save: bool = True):
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.checkpointer = checkpointer
        self.preempt_at_step = preempt_at_step
        self.fault_hook = fault_hook
        self.log_every = log_every
        self.sigterm_save = sigterm_save
        self.start_step = int(state.step)
        self.resumed_from_step: Optional[int] = None
        self.losses: list = []
        self.step_times: list = []      # host seconds of each step run
        self._sigterm_flag = False

    # ------------------------------------------------------------- resume
    def resume(self) -> bool:
        """Restore the newest valid checkpoint into the loop: state, step
        and data cursor.  Returns True when something was restored."""
        if self.checkpointer is None:
            return False
        restored = self.checkpointer.restore_latest(like=self.state)
        if restored is None:
            return False
        state, step, extra = restored
        self.state = state
        self.start_step = int(step)
        self.resumed_from_step = int(step)
        cursor = extra.get("data_cursor")
        if cursor is not None and hasattr(self.data, "seek"):
            self.data.seek(cursor)
        return True

    # ---------------------------------------------------------------- run
    def run(self, total_steps: int) -> Dict[str, Any]:
        """Execute steps ``start_step .. total_steps-1``; returns the run
        summary dict (losses, throughput, checkpoint accounting)."""
        ck = self.checkpointer
        old_term = None
        if ck is not None and self.sigterm_save:
            # flag-only handler: the checkpoint is written *between*
            # steps by the main loop, never from async-signal context
            def _on_term(signum, frame):
                self._sigterm_flag = True

            try:
                old_term = signal.signal(signal.SIGTERM, _on_term)
            except ValueError:          # not the main thread
                old_term = None
        t0 = time.time()
        step_s = 0.0                    # pure step time, ex-checkpointing
        # environmental straggler injection: stall wall-clock per step
        # without touching any math, so a slowed run stays bitwise equal
        try:
            stall_s = float(os.environ.get("REPRO_STEP_DELAY_S", "") or 0)
        except ValueError:
            stall_s = 0.0
        try:
            for i in range(self.start_step, total_steps):
                if self._sigterm_flag:
                    self._checkpoint_and_die()
                if stall_s > 0:
                    time.sleep(stall_s)
                if self.fault_hook is not None:
                    self.fault_hook(i)
                if (self.preempt_at_step is not None
                        and i == self.preempt_at_step
                        and self.resumed_from_step is None):
                    if ck is not None:
                        ck.wait()       # the preemption grace period
                    raise Preemption(
                        f"injected preemption before step {i} "
                        f"(completed {i} of {total_steps})")
                ts = time.time()
                batch = self.data.next_batch()
                self.state, metrics = self.step_fn(self.state, batch)
                self.losses.append(float(metrics["loss"]))
                self.step_times.append(time.time() - ts)
                step_s += self.step_times[-1]
                if self.log_every and (i % self.log_every == 0
                                       or i == total_steps - 1):
                    print(f"step {i:5d} loss {self.losses[-1]:.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.3f}",
                          flush=True)
                if ck is not None and ck.should_save(i + 1):
                    extra = {}          # cursor captured only when saving
                    if hasattr(self.data, "cursor"):
                        extra["data_cursor"] = self.data.cursor()
                    ck.save(self.state, i + 1, extra=extra)
            # a SIGTERM that lands during the final step (or after the
            # loop) still checkpoints before the process dies
            if self._sigterm_flag:
                self._checkpoint_and_die()
        finally:
            if old_term is not None:
                signal.signal(signal.SIGTERM, old_term)
        if ck is not None:
            ck.wait()
        wall = time.time() - t0
        steps_run = max(0, total_steps - self.start_step)
        result: Dict[str, Any] = {
            "steps": total_steps,
            "steps_run": steps_run,
            "resumed_from_step": self.resumed_from_step,
            "wall_s": round(wall, 2),
            "steps_per_s": round(steps_run / wall, 3) if wall else 0.0,
            "pure_step_s": round(step_s, 3),
        }
        if self.losses:
            result.update(first_loss=self.losses[0],
                          final_loss=self.losses[-1],
                          loss_drop=self.losses[0] - self.losses[-1])
        if ck is not None:
            st = ck.stats()
            overhead = (st["blocked_s"] / wall) if wall else 0.0
            result["checkpoint"] = {**st,
                                    "overhead_frac": round(overhead, 4)}
        return result

    # ------------------------------------------------- SIGTERM final save
    def _checkpoint_and_die(self) -> None:
        """A SIGTERM landed between steps: drain in-flight cadence writes,
        publish a final atomic checkpoint at the completed step (state +
        data cursor), then die with the default SIGTERM disposition — the
        scheduler must still see rc = -SIGTERM."""
        ck = self.checkpointer
        if ck is not None:
            ck.wait()
            extra: Dict[str, Any] = {"sigterm": True}
            if hasattr(self.data, "cursor"):
                extra["data_cursor"] = self.data.cursor()
            ck.save(self.state, int(self.state.step), extra=extra)
            ck.wait()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)

    # ---------------------------------------------------- final checkpoint
    def save_final(self, extra: Optional[dict] = None) -> Optional[int]:
        """Force a checkpoint of the current state (e.g. at run end, even
        with no cadence configured).  Returns the checkpointed step."""
        if self.checkpointer is None:
            return None
        step = int(self.state.step)
        payload = dict(extra or {})
        if hasattr(self.data, "cursor"):
            payload.setdefault("data_cursor", self.data.cursor())
        self.checkpointer.save(self.state, step, extra=payload)
        self.checkpointer.wait()
        return step

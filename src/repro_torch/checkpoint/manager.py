"""Durable checkpoint manager: atomic, rotated, optionally-async saves of
a *full* training state (params + optimizer state + step + data cursor),
and a fallback-aware ``restore_latest``.  Port of
``repro.checkpoint.manager``, same layout and protocol.

Layout under the manager's root directory::

    <root>/step_00000015/shard_0000.npz
    <root>/step_00000015/manifest.json      # written last, fsynced
    <root>/step_00000030/...

Durability protocol (what survives a preemption mid-write):

* a save writes into ``<root>/.tmp-...`` — shards first, manifest last
  with fsync — then publishes with an atomic ``os.replace`` to
  ``step_N``; readers never observe a half-written ``step_N``;
* rotation deletes oldest published checkpoints beyond ``keep_last``
  only after the new one is published;
* ``restore_latest`` walks published checkpoints newest-first and skips
  (with a note) any that fail validation — a torn checkpoint costs the
  work since the previous one, never the run.

Async mode snapshots the state to host memory on the caller's thread
(the only part that must see a consistent state) and performs the disk
write on a single background worker, so the training hot path only ever
pays the snapshot + any wait for a previous in-flight save.  The snapshot
is a real copy of every tensor: the train step updates the state in place,
and must never race the writer.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.io import (CheckpointError, _flatten,
                                       load_checkpoint, read_manifest,
                                       save_checkpoint)

_STEP_PREFIX = "step_"


def _step_dir(step: int) -> str:
    return f"{_STEP_PREFIX}{step:08d}"


def list_checkpoints(directory) -> List[Tuple[int, Path]]:
    """Published (step, path) pairs under ``directory``, oldest first.
    Only well-formed ``step_N`` names count — tmp dirs are invisible."""
    d = Path(directory)
    if not d.exists():
        return []
    out = []
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith(_STEP_PREFIX):
            try:
                out.append((int(p.name[len(_STEP_PREFIX):]), p))
            except ValueError:
                continue
    return sorted(out)


class CheckpointManager:
    """Owns one checkpoint directory: cadence, atomicity, rotation,
    restore-with-fallback, and save-time accounting.

    Parameters
    ----------
    directory:        checkpoint root (created on first save).
    keep_last:        retain at most this many published checkpoints.
    every_steps:      ``maybe_save`` cadence in completed steps (0/None
                      disables step-cadence saves).
    every_s:          additional wallclock cadence — save when this many
                      seconds elapsed since the last save, even between
                      step boundaries.
    async_saves:      write on a background thread (default); the hot
                      path pays only the host snapshot.
    period:           the model's ``period_len``: layer p*P + j is row p
                      of ``periods/slot{j}``.
    """

    def __init__(self, directory, *, keep_last: int = 3,
                 every_steps: Optional[int] = None,
                 every_s: Optional[float] = None,
                 async_saves: bool = True, period: int = 1):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = Path(directory)
        self.keep_last = keep_last
        self.every_steps = int(every_steps or 0)
        self.every_s = float(every_s or 0.0)
        self.async_saves = async_saves
        self.period = period
        self._last_save_t = time.time()
        # accounting (read via .stats())
        self.saves = 0
        self.save_s = 0.0           # background/disk write time
        self.blocked_s = 0.0        # hot-path time: snapshot + queue wait
        self.restore_skipped: List[str] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker: Optional[threading.Thread] = None
        self._worker_err: Optional[BaseException] = None

    # ------------------------------------------------------------ cadence
    def should_save(self, completed_steps: int) -> bool:
        if self.every_steps and completed_steps % self.every_steps == 0:
            return True
        if self.every_s and (time.time() - self._last_save_t) >= self.every_s:
            return True
        return False

    def maybe_save(self, state, completed_steps: int,
                   extra: Optional[dict] = None) -> bool:
        if completed_steps > 0 and self.should_save(completed_steps):
            self.save(state, completed_steps, extra=extra)
            return True
        return False

    # -------------------------------------------------------------- save
    def save(self, state, step: int, extra: Optional[dict] = None) -> None:
        """Durably checkpoint ``state`` as ``step_<step>``.  Returns once
        the save is (async mode) enqueued with a consistent host snapshot,
        or (sync mode) published.  A step that is already durably
        published is not re-written — touching it would risk the one
        invariant that matters (the newest published checkpoint survives
        any kill)."""
        if self.latest_step() == int(step):
            try:                        # only trust an intact manifest
                read_manifest(self.directory / _step_dir(int(step)))
                return
            except CheckpointError:
                pass                    # torn: fall through and re-write
        t0 = time.time()
        # host snapshot: a real COPY of every leaf (``_flatten`` copies),
        # since the train step updates the same tensors in place
        snapshot = _flatten(state, period=self.period)
        metadata = dict(extra or {})
        if self.async_saves:
            self._ensure_worker()
            self._raise_worker_error()
            self._q.put((snapshot, int(step), metadata))  # waits if in flight
            self.blocked_s += time.time() - t0
        else:
            self._write(snapshot, int(step), metadata)
            self.blocked_s += time.time() - t0
        self._last_save_t = time.time()

    def _write(self, snapshot, step: int, metadata: dict) -> None:
        t0 = time.time()
        self.directory.mkdir(parents=True, exist_ok=True)
        tmp = self.directory / f".tmp-{_step_dir(step)}-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        save_checkpoint(tmp, snapshot, step=step, metadata=metadata,
                        fsync=True)
        final = self.directory / _step_dir(step)
        old = None
        if final.exists():              # re-save of the same step: move the
            old = self.directory / f".old-{final.name}-{os.getpid()}"
            if old.exists():
                shutil.rmtree(old)
            os.replace(final, old)      # published copy aside first, so a
        os.replace(tmp, final)          # kill here still leaves one intact
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        self._rotate()
        self.saves += 1
        self.save_s += time.time() - t0

    def _rotate(self) -> None:
        ckpts = list_checkpoints(self.directory)
        for _, path in ckpts[:max(0, len(ckpts) - self.keep_last)]:
            shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------ async worker
    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return

        def loop():
            while True:
                item = self._q.get()
                if item is None:
                    return
                try:
                    self._write(*item)
                except BaseException as e:  # surfaced on next save/wait
                    self._worker_err = e
                finally:
                    self._q.task_done()

        self._worker = threading.Thread(target=loop, daemon=True,
                                        name="checkpoint-writer")
        self._worker.start()

    def _raise_worker_error(self) -> None:
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            raise CheckpointError(
                f"background checkpoint write failed: {err}") from err

    def wait(self) -> None:
        """Block until all enqueued saves are published (and re-raise any
        background write failure)."""
        if self._worker is not None:
            self._q.join()
        self._raise_worker_error()

    def close(self) -> None:
        self.wait()
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._worker.join(timeout=5.0)
        self._worker = None

    # ------------------------------------------------------------ restore
    def restore_latest(self, like=None
                       ) -> Optional[Tuple[Any, int, Dict[str, Any]]]:
        """Restore the newest valid checkpoint: ``(state, step, extra)``,
        or ``None`` when no usable checkpoint exists.  Torn/corrupt
        checkpoints are skipped (recorded in ``restore_skipped``) and the
        walk falls back to the previous one."""
        self.wait()
        for step, path in reversed(list_checkpoints(self.directory)):
            try:
                manifest = read_manifest(path)
                tree, mstep = load_checkpoint(path, like=like,
                                              period=self.period)
            except CheckpointError as e:
                self.restore_skipped.append(f"{path.name}: {e}")
                continue
            return tree, int(mstep), dict(manifest.get("metadata", {}))
        return None

    def latest_step(self) -> Optional[int]:
        ckpts = list_checkpoints(self.directory)
        return ckpts[-1][0] if ckpts else None

    # ---------------------------------------------------------- accounting
    def stats(self) -> Dict[str, Any]:
        return {
            "saves": self.saves,
            "save_s": round(self.save_s, 4),
            "blocked_s": round(self.blocked_s, 4),
            "async": self.async_saves,
            "keep_last": self.keep_last,
            "restore_skipped": list(self.restore_skipped),
        }

"""Survivable concurrent campaign execution (the port's copy of
``repro.core.executor``) — the multi-process counterpart of
:meth:`Orchestrator.run_local`'s sequential loop and the execution-layer
realization of what :class:`repro_torch.core.scheduler.ClusterSim` only
models.

:class:`CampaignExecutor` launches every pending job as a

    python -m repro_torch.launch run <kind> --arch ... --key value ...

subprocess (the container semantics of a Kubernetes Job: the child sees
only its spec, rebuilt from CLI flags, and prints a RunReport JSON), with

* **resource-aware admission** — a :class:`ResourcePool` over the same
  :class:`~repro_torch.core.scheduler.NodeSpec` inventory the cluster sim
  schedules against, FIFO within priority (``JobSpec.priority``, higher
  first).  Admission requests are *learned*: a
  :class:`~repro_torch.core.scheduler.LearnedRequests` model tightens each
  job's declared request to the observed p95 usage of completed attempts
  of the same kind (clamped to declared as a ceiling, so the pool can
  never admit past what the node really has);
* **backfill** (opt-in) — when the head of the queue does not fit, a
  smaller job may jump into capacity the head cannot use, under a
  starvation bound: a backfill candidate is admitted only if it provably
  cannot delay the head's earliest feasible start (its target node could
  never host the head, or its estimated runtime ends before the head's
  earliest feasible start computed from observed attempt walls);
* **speculative duplicates** (opt-in) — a running attempt whose progress
  (steps/s from its published checkpoint manifests) falls below
  ``slow_fraction`` of the campaign median gets a duplicate attempt in a
  sibling checkpoint dir, admitted under the same rules.  First finisher
  wins; the loser is SIGKILLed and logged as ``speculation_loss``, and
  the winner's checkpoint dir is promoted to the declared path — results
  stay bitwise-identical to non-speculative runs;
* **scheduler-crash recovery** — ``resume=True`` replays the durable
  event log, marks completed jobs done (never re-executing them),
  re-adopts still-alive orphan attempts by pid + kernel start-time
  identity, and re-queues dead orphans through the ``retry_env`` resume
  path.  SIGKILLing the *executor* mid-campaign loses no completed work;
* **per-attempt resource telemetry** — a sampler thread records CPU%,
  RSS and io counters per attempt into the event log; completed-attempt
  usage feeds the learned-request model and ``campaign status``;
* **real preemption** — an optional :class:`ChaosSpec` SIGKILLs running
  workers mid-step; a killed attempt is re-admitted with the job's
  ``retry_env`` overlay (``resume=true`` for train), so the
  CheckpointManager restores it from the last durable checkpoint.
  Failed (non-signal) attempts retry under exponential backoff with
  deterministic jitter; timed-out attempts get their own ``timeout``
  outcome and count into lost-work accounting;
* **a durable JSONL event log** (``campaign/events.jsonl``, fsynced per
  event) that powers ``python -m repro_torch.launch campaign status`` and
  replays — incrementally, from any prefix — to a consistent state.

The subprocess spawn is injectable (``spawn=``), as are the clock
(``clock=``), the progress probe (``progress_fn=``) and the learned
request model (``learned=``), so scheduling, chaos, speculation and
backoff can all be exercised hermetically in tests without paying a torch
import per job.  The executor itself imports no torch and creates no CUDA
context: on one card, the scheduler holds none of the memory its children
need.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import signal as _signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import (Any, Callable, Dict, IO, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from repro_torch.core.artifacts import PersistentVolume, S3Store
from repro_torch.core.jobs import JobRecord, JobSpec, JobState, Resources
from repro_torch.core.scheduler import LearnedRequests, NodeSpec

EVENTS_REL = "campaign/events.jsonl"
_CKPT_PREFIX = "step_"


# --------------------------------------------------------------------------
# Resource-aware admission
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _FreeNode:
    spec: NodeSpec
    name: str
    gpus_free: int = 0
    cpus_free: int = 0
    mem_free: float = 0.0
    # a draining node admits nothing and is removed from the pool once
    # its last resident attempt releases (Kubernetes cordon+drain)
    draining: bool = False

    def __post_init__(self):
        self.gpus_free = self.spec.gpus
        self.cpus_free = self.spec.cpus
        self.mem_free = self.spec.memory_gb


class ResourcePool:
    """Free-capacity accounting over a :class:`NodeSpec` inventory.

    The executor admits through :meth:`admit` and returns capacity
    through :meth:`release`; *which* fitting node an admission lands on
    is decided by a pluggable
    :class:`repro_torch.core.placement.PlacementPolicy` (``best_fit`` by
    default — the cluster sim's historical rule), selected by the same
    name end-to-end from ``campaign run --placement``.  The pool is the
    single source of truth for the "never oversubscribe a node"
    invariant; both methods raise if it would be violated, whatever the
    policy ranks first.

    The inventory is **elastic**: :meth:`add_node` grows it mid-campaign
    and :meth:`drain` + :meth:`remove_node` shrink it.  Shrink never
    races capacity: a draining node stops admitting immediately but keeps
    its residents' accounting until they release, and :meth:`remove_node`
    refuses any node that is not both draining and fully free — so the
    never-oversubscribe invariant holds through any resize interleaving.
    """

    def __init__(self, inventory: Sequence[NodeSpec],
                 policy: Union[str, "PlacementPolicy", None] = None):
        from repro_torch.core.placement import get_placement_policy
        self.policy = get_placement_policy(policy)
        self.nodes: List[_FreeNode] = []
        for spec in inventory:
            for i in range(spec.count):
                self.nodes.append(_FreeNode(spec, f"{spec.name}-{i:03d}"))
        if not self.nodes:
            raise ValueError("empty inventory")
        # monotonic name counter for add_node: never reused, so a
        # grow -> shrink -> grow interleaving cannot regenerate a live
        # name (len(self.nodes) could, once removals shifted it back)
        self._node_seq = len(self.nodes)

    def fits_when_empty(self, res: Resources) -> bool:
        """Could this request *ever* be placed?  Guards against queueing
        a job that would wait forever (the executor fails it instead).
        Draining nodes don't count — their capacity is leaving."""
        return any(res.fits(n.spec.gpus, n.spec.cpus, n.spec.memory_gb,
                            n.spec.gpu_memory_gb)
                   for n in self.nodes if not n.draining)

    def fits_when_empty_gang(self, res: Resources, n: int) -> bool:
        """Could ``n`` ranks of ``res`` *ever* be co-placed on an empty
        cluster?  Trial-places the whole gang on a pristine copy of the
        inventory (ranks may share a node when its capacity allows)."""
        if n <= 1:
            return self.fits_when_empty(res)
        keep = [dataclasses.replace(node.spec, count=1)
                for node in self.nodes if not node.draining]
        if not keep:
            return False
        trial = ResourcePool(keep, policy=self.policy)
        return trial.admit_gang(res, n) is not None

    # ------------------------------------------------------- elasticity
    def clone(self) -> "ResourcePool":
        """A deep copy of the current free-capacity state (the evictor
        simulates releases on a clone before killing anything)."""
        dup = ResourcePool.__new__(ResourcePool)
        dup.policy = self.policy
        dup._node_seq = self._node_seq
        dup.nodes = []
        for n in self.nodes:
            m = _FreeNode(n.spec, n.name)
            m.gpus_free, m.cpus_free, m.mem_free = \
                n.gpus_free, n.cpus_free, n.mem_free
            m.draining = n.draining
            dup.nodes.append(m)
        return dup

    def node(self, name: str) -> Optional[_FreeNode]:
        return next((n for n in self.nodes if n.name == name), None)

    def add_node(self, spec: NodeSpec, name: Optional[str] = None) -> str:
        """Grow the inventory by one node (empty, immediately
        admittable).  Returns its name.  Generated names come from a
        monotonic counter that never rewinds, so grow -> shrink -> grow
        cannot collide with a surviving node the way ``len(self.nodes)``
        once could."""
        if name is None:
            name = f"{spec.name}-{self._node_seq:03d}"
            while self.node(name) is not None:
                self._node_seq += 1
                name = f"{spec.name}-{self._node_seq:03d}"
            self._node_seq += 1
        node = _FreeNode(dataclasses.replace(spec, count=1), name)
        if self.node(node.name) is not None:
            raise ValueError(f"duplicate node name {node.name}")
        self.nodes.append(node)
        return node.name

    def drain(self, name: str) -> None:
        """Cordon ``name``: stop admitting to it.  Residents keep their
        capacity until they release; remove with :meth:`remove_node`
        once :meth:`drained_free` reports it empty."""
        node = self.node(name)
        if node is None:
            raise KeyError(f"unknown node {name}")
        node.draining = True

    def undrain(self, name: str) -> None:
        node = self.node(name)
        if node is None:
            raise KeyError(f"unknown node {name}")
        node.draining = False

    def drained_free(self) -> List[str]:
        """Draining nodes whose last resident has released — safe to
        remove without touching any live accounting."""
        return [n.name for n in self.nodes
                if n.draining and n.gpus_free == n.spec.gpus
                and n.cpus_free == n.spec.cpus
                and n.mem_free >= n.spec.memory_gb - 1e-9]

    def remove_node(self, name: str) -> None:
        node = self.node(name)
        if node is None:
            raise KeyError(f"unknown node {name}")
        if name not in self.drained_free():
            raise RuntimeError(
                f"refusing to remove node {name}: not draining or still "
                f"hosting attempts")
        self.nodes.remove(node)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Per-node capacity + drain state, for events and status."""
        return [{"name": n.name, "gpus": n.spec.gpus,
                 "cpus": n.spec.cpus, "memory_gb": n.spec.memory_gb,
                 "gpu_memory_gb": n.spec.gpu_memory_gb,
                 "draining": n.draining}
                for n in self.nodes]

    def admit_gang(self, res: Resources, n: int) -> Optional[List[str]]:
        """All-or-nothing **co-located** placement of ``n`` ranks, each
        requesting ``res``: returns the per-rank node names, or None
        with nothing held (no hold-and-wait, so concurrent gangs can
        never deadlock on each other's partial grabs).

        Ranks land on the *fewest nodes possible* — intra-node ranks
        talk over NVLink/shared memory while cross-node ranks pay the
        network, so node count is the gang's topology cost.  Greedy
        largest-remaining-capacity selection is optimal for identical
        ranks; capacity ties fall back to the pool's placement policy
        (the candidate list is policy-ordered and the sort is stable).
        The full placement is computed against free capacity *before*
        anything is committed, so failure rolls back by construction
        and success can never oversubscribe (the per-rank commit still
        re-checks, like :meth:`admit`)."""
        from repro_torch.core.placement import gang_rank_capacity
        n = max(1, n)
        cands = self._candidates(res)          # policy-ordered
        ranked = sorted(
            ((node, gang_rank_capacity(node, res, n)) for node in cands),
            key=lambda nc: -nc[1])             # stable: policy breaks ties
        chosen: List[Tuple[_FreeNode, int]] = []
        remaining = n
        for node, cap in ranked:
            if remaining <= 0:
                break
            take = min(cap, remaining)
            if take <= 0:
                continue
            chosen.append((node, take))
            remaining -= take
        if remaining > 0:
            return None                        # nothing was committed
        placed: List[str] = []
        for node, take in chosen:
            for _ in range(take):
                node.gpus_free -= res.gpus
                node.cpus_free -= res.cpus
                node.mem_free -= res.memory_gb
                if (node.gpus_free < 0 or node.cpus_free < 0
                        or node.mem_free < -1e-9):
                    raise RuntimeError(f"oversubscribed node {node.name}")
                placed.append(node.name)
        return placed

    def _candidates(self, res: Resources) -> List[_FreeNode]:
        cands = [n for n in self.nodes
                 if not n.draining
                 and res.fits(n.gpus_free, n.cpus_free, n.mem_free,
                              n.spec.gpu_memory_gb)]
        return self.policy.order(cands, res)

    def peek_node(self, res: Resources) -> Optional[_FreeNode]:
        """The node :meth:`admit` would pick right now, without
        admitting (backfill uses this to reason about placement)."""
        cands = self._candidates(res)
        return cands[0] if cands else None

    def admit(self, res: Resources,
              prefer: Optional[str] = None) -> Optional[str]:
        """Place one request; ``prefer`` pins it to that node when it
        fits (adoption re-charges an orphan where its process already
        runs — free re-placement would swap nodes between orphans and
        the event log would claim a placement that never happened)."""
        cands = self._candidates(res)
        if not cands:
            return None
        node = cands[0]
        if prefer is not None:
            pinned = next((n for n in cands if n.name == prefer), None)
            if pinned is not None:
                node = pinned
        node.gpus_free -= res.gpus
        node.cpus_free -= res.cpus
        node.mem_free -= res.memory_gb
        if node.gpus_free < 0 or node.cpus_free < 0 or node.mem_free < -1e-9:
            raise RuntimeError(f"oversubscribed node {node.name}")
        return node.name

    def release(self, node_name: str, res: Resources) -> None:
        node = next(n for n in self.nodes if n.name == node_name)
        node.gpus_free += res.gpus
        node.cpus_free += res.cpus
        node.mem_free += res.memory_gb
        if (node.gpus_free > node.spec.gpus
                or node.cpus_free > node.spec.cpus
                or node.mem_free > node.spec.memory_gb + 1e-9):
            raise RuntimeError(f"release overflow on node {node.name}")

    def in_use(self) -> Dict[str, Tuple[int, int, float]]:
        return {n.name: (n.spec.gpus - n.gpus_free,
                         n.spec.cpus - n.cpus_free,
                         n.spec.memory_gb - n.mem_free)
                for n in self.nodes}


def local_inventory(workers: int, jobs: Sequence[JobSpec]) -> List[NodeSpec]:
    """Default inventory for local execution: one node per worker, each
    sized to the largest single-job request — every worker slot fits
    exactly one job, so admission degenerates to the worker cap while
    still flowing through the resource accounting."""
    gpus = max([j.resources.gpus for j in jobs] or [1])
    cpus = max([j.resources.cpus for j in jobs] or [1])
    mem = max([j.resources.memory_gb for j in jobs] or [1.0])
    vram = max([j.resources.gpu_memory_gb_min for j in jobs] or [0.0])
    return [NodeSpec("worker", gpus=gpus, gpu_memory_gb=vram, cpus=cpus,
                     memory_gb=mem, count=max(1, int(workers)))]


# --------------------------------------------------------------------------
# Speculative duplicates
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SpeculationSpec:
    """Straggler defense: first-finisher-wins duplicate launches.

    A running primary attempt becomes a speculation victim when

    * it has been alive at least ``min_runtime_s`` seconds, and — when
      ``grace`` is not None — longer than ``grace`` x the mean wall time
      of completed attempts of its kind (short jobs spend most of their
      wall in startup; a run that should already have finished is the
      honest straggler signal), and
    * its measured progress (steps/s from published checkpoint
      manifests by default) is below ``slow_fraction`` x the campaign
      median over at least ``min_peers`` peer measurements (live
      same-kind attempts, topped up with completed-attempt rates).

    The duplicate runs the *same spec* in a sibling checkpoint dir
    (``<dir>.specN``), admitted through the same pool under the same
    resource request, only into capacity the queue does not want.  The
    first attempt to finish wins; the loser is SIGKILLed and its wall
    time logged as ``speculation_loss``; the winner's checkpoint dir is
    promoted to the declared path, so downstream consumers see bitwise
    the same artifacts as a non-speculative run.
    """

    slow_fraction: float = 0.5
    min_runtime_s: float = 2.0
    grace: Optional[float] = 1.0
    min_peers: int = 2
    max_duplicates_per_job: int = 1


# --------------------------------------------------------------------------
# Fault injection
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ChaosSpec:
    """Inject real preemptions: SIGKILL selected jobs mid-run.

    ``kill_jobs`` names the victims; each is killed at most
    ``max_kills_per_job`` times.  A kill fires when the job's published
    checkpoint count reaches ``after_checkpoints`` (so the resume path is
    genuinely exercised) or — for jobs without a checkpoint dir, or when
    ``after_checkpoints == 0`` — after the attempt has been alive
    ``after_s`` seconds.  Speculative duplicate attempts are never chaos
    victims (chaos models node preemption of the *primary* placement).
    """

    kill_jobs: Sequence[str] = ()
    after_checkpoints: int = 1
    after_s: float = 0.0
    signal: int = int(_signal.SIGKILL)
    max_kills_per_job: int = 1

    @classmethod
    def sample(cls, names: Sequence[str], fraction: float = 0.5,
               seed: int = 0, **kw) -> "ChaosSpec":
        """Random-but-deterministic victim selection over ``names``."""
        rng = random.Random(seed)
        k = min(len(names), max(1, round(len(names) * fraction))) \
            if names else 0
        return cls(kill_jobs=sorted(rng.sample(list(names), k)), **kw)

    def wants_kill(self, job_name: str, kills_done: int, alive_s: float,
                   published_ckpts: Optional[int]) -> bool:
        if job_name not in self.kill_jobs:
            return False
        if kills_done >= self.max_kills_per_job:
            return False
        if self.after_checkpoints > 0 and published_ckpts is not None:
            return published_ckpts >= self.after_checkpoints
        return self.after_s > 0 and alive_s >= self.after_s


def _published_checkpoints(directory: Optional[str]) -> Optional[int]:
    """Count published ``step_N`` checkpoints without importing torch
    (the executor process never loads an ML stack)."""
    if not directory:
        return None
    d = Path(directory)
    if not d.is_dir():
        return 0
    n = 0
    for p in d.iterdir():
        if (p.is_dir() and p.name.startswith(_CKPT_PREFIX)
                and (p / "manifest.json").exists()):
            n += 1
    return n


def _latest_checkpoint_step(directory: Optional[str]) -> Optional[int]:
    """Newest published checkpoint step under ``directory`` (manifest
    presence required), again without any ML import."""
    if not directory:
        return None
    d = Path(directory)
    if not d.is_dir():
        return None
    best = None
    for p in d.iterdir():
        if (p.is_dir() and p.name.startswith(_CKPT_PREFIX)
                and (p / "manifest.json").exists()):
            try:
                step = int(p.name[len(_CKPT_PREFIX):])
            except ValueError:
                continue
            best = step if best is None else max(best, step)
    return best


def checkpoint_progress(run: "_Running", now: float) -> Optional[float]:
    """Default progress probe: steps/s inferred from the attempt's
    newest published checkpoint manifest.  None when the attempt has no
    checkpoint dir or nothing published yet (fresh attempts are never
    judged stragglers on zero evidence)."""
    step = _latest_checkpoint_step(run.ckpt_dir)
    if step is None or step <= 0:
        return None
    alive = now - run.started_t
    return step / alive if alive > 0 else None


# --------------------------------------------------------------------------
# PID identity + orphan adoption
# --------------------------------------------------------------------------
def _pid_start_time(pid: int) -> Optional[int]:
    """Kernel start time (clock ticks since boot) of ``pid`` from
    /proc/<pid>/stat — with the pid number, a unique process identity
    that survives pid reuse.  None off-Linux or when unreadable."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as fh:
            data = fh.read().decode("ascii", "replace")
        # fields after the parenthesized comm (which may contain spaces):
        # state is overall field 3 == index 0 here; starttime is field 22
        return int(data.rsplit(") ", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return None


def _pid_alive(pid: Optional[int],
               pid_start: Optional[int] = None) -> bool:
    """Is ``pid`` alive *and the same process* we recorded?  A recycled
    pid (different kernel start time) counts as dead."""
    if not pid:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass                         # exists, owned by someone else
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat", "rb") as fh:
            tail = fh.read().decode("ascii", "replace") \
                .rsplit(") ", 1)[1].split()
    except (OSError, IndexError):
        return True                  # off-Linux: os.kill was the answer
    # a zombie has exited — its outcome is final even if nobody reaped
    # it yet (an adopted orphan's original parent may never wait on it)
    if tail and tail[0] == "Z":
        return False
    if pid_start is not None:
        try:
            if int(tail[19]) != pid_start:
                return False         # recycled pid: a different process
        except (IndexError, ValueError):
            pass
    return True


class _AdoptedHandle:
    """Popen-shaped handle over an orphan attempt re-adopted after a
    scheduler crash.  The orphan is not our child, so there is no exit
    code to reap: liveness is pid + start-time identity, and the outcome
    is judged from the trailing RunReport in the attempt's stdout log
    (exactly the executor's success criterion for its own children)."""

    def __init__(self, pid: int, pid_start: Optional[int],
                 stdout_path: Path):
        self.pid = pid
        self.pid_start = pid_start
        self.stdout_path = Path(stdout_path)
        self.adopted = True

    def poll(self) -> Optional[int]:
        if _pid_alive(self.pid, self.pid_start):
            return None
        try:
            report = parse_trailing_report(
                self.stdout_path.read_text(errors="replace"))
        except OSError:
            report = None
        return 0 if report and report.get("status") != "failed" else 1

    def send_signal(self, sig: int) -> None:
        if _pid_alive(self.pid, self.pid_start):
            try:
                os.kill(self.pid, sig)
            except OSError:
                pass


class _GangHandle:
    """Popen-shaped handle over a gang of rank processes.

    ``poll`` returns None while any rank lives.  The first rank to die
    with a nonzero code (or signal) condemns the gang: every other live
    rank is killed — **gracefully** when ``grace_s`` is set (SIGTERM
    first, so survivors get the grace window to write a final
    checkpoint, then SIGKILL once the window expires), immediately
    otherwise — and once all are dead the condemning code is the gang's
    exit code, so the executor's existing preempted/failed branches
    apply unchanged to whole gangs.  All ranks exiting 0 is a gang
    success.  ``pid`` is rank 0's (the telemetry sampler and event
    identity follow the coordinator rank).
    """

    def __init__(self, procs: Sequence[Any],
                 on_rank_exit: Optional[Callable[[int, int], None]]
                 = None, grace_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.procs = list(procs)
        self.pid = getattr(self.procs[0], "pid", None)
        self.on_rank_exit = on_rank_exit
        self.grace_s = grace_s
        self.clock = clock or time.time
        self.rcs: List[Optional[int]] = [None] * len(self.procs)
        self._condemned: Optional[int] = None
        self._condemned_t: Optional[float] = None
        self._escalated = False

    def poll(self) -> Optional[int]:
        for i, proc in enumerate(self.procs):
            if self.rcs[i] is not None:
                continue
            rc = proc.poll()
            if rc is None:
                continue
            self.rcs[i] = rc
            if self.on_rank_exit is not None:
                self.on_rank_exit(i, rc)
            if rc != 0 and self._condemned is None:
                self._condemned = rc
                self._condemned_t = self.clock()
                if self.grace_s is not None:
                    self._signal_live(int(_signal.SIGTERM))
                else:
                    self._kill_live()
        if (self._condemned_t is not None and not self._escalated
                and self.grace_s is not None
                and self.clock() - self._condemned_t >= self.grace_s):
            # survivors did not exit within the grace window (e.g. a
            # rank wedged in a collective on its dead peer): escalate
            self._escalated = True
            self._kill_live()
        if any(rc is None for rc in self.rcs):
            return None
        return self._condemned if self._condemned is not None else 0

    def _signal_live(self, sig: int) -> None:
        for i, proc in enumerate(self.procs):
            if self.rcs[i] is None:
                try:
                    proc.send_signal(sig)
                except OSError:      # pragma: no cover - exit race
                    pass

    def _kill_live(self) -> None:
        self._signal_live(int(_signal.SIGKILL))

    def send_signal(self, sig: int) -> None:
        for i, proc in enumerate(self.procs):
            if self.rcs[i] is None:
                try:
                    proc.send_signal(sig)
                except OSError:      # pragma: no cover - exit race
                    pass

    def signal_rank(self, rank: int, sig: int) -> None:
        """Deliver to ONE rank (chaos kills a single rank to prove the
        whole-gang requeue propagates from any member's death)."""
        if self.rcs[rank] is None:
            try:
                self.procs[rank].send_signal(sig)
            except OSError:          # pragma: no cover - exit race
                pass


# --------------------------------------------------------------------------
# Per-attempt resource telemetry (/proc sampling)
# --------------------------------------------------------------------------
def _read_cpu_ticks(pid: int) -> Optional[int]:
    try:
        with open(f"/proc/{pid}/stat", "rb") as fh:
            fields = fh.read().decode("ascii", "replace") \
                .rsplit(") ", 1)[1].split()
        return int(fields[11]) + int(fields[12])      # utime + stime
    except (OSError, IndexError, ValueError):
        return None


def _read_rss_mb(pid: int) -> Optional[float]:
    try:
        with open(f"/proc/{pid}/status", encoding="ascii",
                  errors="replace") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, IndexError, ValueError):
        pass
    return None


def _read_io_mb(pid: int) -> Tuple[Optional[float], Optional[float]]:
    try:
        vals = {}
        with open(f"/proc/{pid}/io", encoding="ascii",
                  errors="replace") as fh:
            for line in fh:
                key, _, val = line.partition(":")
                vals[key.strip()] = val.strip()
        return (int(vals["read_bytes"]) / 1e6,
                int(vals["write_bytes"]) / 1e6)
    except (OSError, KeyError, ValueError):
        return None, None


# --------------------------------------------------------------------------
# Subprocess plumbing
# --------------------------------------------------------------------------
def job_run_argv(job: JobSpec, *, resume: bool = False,
                 env_overlay: Optional[Mapping[str, str]] = None
                 ) -> List[str]:
    """Rebuild the ``repro_torch.launch run`` argv from the job's env
    encoding (the manifest is the source of truth, exactly as on a
    cluster).  With ``resume=True`` the job's ``retry_env`` overlay is
    applied first — the same semantics ``run_local`` gives in-process retries.
    ``env_overlay`` applies last (speculative duplicates redirect
    ``CHECKPOINT_DIR`` to their sibling workdir through it)."""
    # lazy: api -> core
    from repro_torch.api.spec import RunSpec, _encode_scalar
    env = dict(job.env)
    if resume and job.retry_env:
        env.update(job.retry_env)
    if env_overlay:
        env.update(env_overlay)
    spec = RunSpec.from_env(env)
    argv = ["run", spec.kind, "--arch", spec.arch,
            "--seed", str(spec.seed), "--name", job.name]
    for key, val in sorted(spec.overrides.items()):
        argv.append(f"--{key}={_encode_scalar(val)}")
    return argv


def _src_path() -> str:
    # .../src/repro/core/executor.py -> .../src
    return str(Path(__file__).resolve().parents[2])


def _default_spawn(job: JobSpec, attempt: int, argv: List[str],
                   env: Dict[str, str], stdout: IO, stderr: IO):
    return subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr)


def parse_trailing_report(text: str) -> Optional[Dict[str, Any]]:
    """Extract the final RunReport JSON from a run's stdout (step logs
    precede it; ``RunReport.to_json`` prints an indent-1 object whose
    first line is ``{``)."""
    lines = text.splitlines()
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].lstrip().startswith("{"):
            try:
                obj = json.loads("\n".join(lines[i:]))
            except ValueError:
                continue
            if isinstance(obj, dict) and "status" in obj:
                return obj
    return None


# --------------------------------------------------------------------------
# Durable event log + replay
# --------------------------------------------------------------------------
class EventLog:
    """Append-only JSONL, fsynced per event — survives a SIGKILL of the
    orchestrating process itself.  Emission is thread-safe (the
    telemetry sampler thread writes concurrently with the main loop)."""

    def __init__(self, path: Path,
                 clock: Optional[Callable[[], float]] = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._seq = 0
        self._clock = clock or time.time
        self._lock = threading.Lock()

    def emit(self, event: str, **fields) -> Dict[str, Any]:
        with self._lock:
            rec = {"event": event, "seq": self._seq,
                   "t": round(self._clock(), 4), **fields}
            self._seq += 1
            self._fh.write(json.dumps(rec, sort_keys=True, default=str)
                           + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
        return rec

    def close(self) -> None:
        with self._lock:
            self._fh.close()


TERMINAL_EVENTS = ("succeeded", "failed", "unschedulable")


def _new_job_state() -> Dict[str, Any]:
    return {"state": "Pending", "attempts": 0, "node": None,
            "preemptions": 0, "chaos_kills": 0, "timeouts": 0,
            "resumed_from_step": None, "error": None,
            "kind": None, "declared": None, "telemetry": None,
            "declared_vs_observed": None,
            "backfills": 0, "adoptions": 0,
            "speculative_launches": 0, "speculation_losses": 0,
            "speculation_loss_wall_s": 0.0,
            "winner_ckpt_dir": None, "promoted": False,
            "succeeded_wall_s": None,
            "evictions": 0, "gang_shrunk_from": None,
            "gang": 1, "gang_id": None, "ranks": {},
            "live": {}, "_last_exit_wall": None}


def _fresh_replay_state() -> Dict[str, Any]:
    return {"jobs": {}, "workers": None, "ended": False,
            "makespan_s": None, "resumes": 0, "violations": [],
            "nodes": {}, "_alloc": {},
            # utilization ledger accumulators (area under the per-node
            # allocation curve, integrated from event timestamps):
            # _util[name] holds raw busy/goodput/available second
            # integrals, _util_pending holds released-but-unclassified
            # attempt intervals (goodput is decided by the terminal
            # event), _t_hi is the newest event time seen (campaign_end
            # excluded, so the executor's own summary — written just
            # before campaign_end — derives the identical ledger)
            "_util": {}, "_util_pending": {}, "_t_hi": None}


def _node_entry(d: Mapping[str, Any]) -> Dict[str, Any]:
    return {"gpus": int(d.get("gpus") or 0),
            "cpus": int(d.get("cpus") or 0),
            "memory_gb": float(d.get("memory_gb") or 0.0),
            "draining": bool(d.get("draining")),
            "used": {"gpus": 0, "cpus": 0, "memory_gb": 0.0}}


def _replay_allocate(st8: Dict[str, Any], violations: List[str],
                     job: str, att, placements: Sequence[str],
                     res: Mapping[str, Any],
                     t: Optional[float] = None,
                     check: bool = True) -> None:
    """Charge one attempt's admission against the replayed node
    inventory; any oversubscription or admit-to-draining is a replay
    violation.  Logs from before inventory-carrying campaign_start
    events have no ``nodes`` — then this is a silent no-op.  ``t``
    opens the attempt's utilization interval (closed by
    :func:`_replay_release`).  ``check=False`` suppresses the
    violations for cross-generation handoffs (``adopted`` events): the
    dead scheduler's stale charges are still on the books until the
    resume path clears them, so transient double-occupancy there is
    bookkeeping lag, not a real oversubscription."""
    nodes = st8["nodes"]
    if not nodes or not res:
        return
    alloc = st8["_alloc"].setdefault(f"{job}:{att}", [])
    for nd in placements:
        info = nodes.get(nd)
        if info is None:
            continue
        if check and info["draining"]:
            violations.append(f"{job}: admitted to draining node {nd}")
        used = info["used"]
        used["gpus"] += int(res.get("gpus") or 0)
        used["cpus"] += int(res.get("cpus") or 0)
        used["memory_gb"] = round(
            used["memory_gb"] + float(res.get("memory_gb") or 0.0), 6)
        if check and (used["gpus"] > info["gpus"]
                      or used["cpus"] > info["cpus"]
                      or used["memory_gb"] > info["memory_gb"] + 1e-6):
            violations.append(f"oversubscribed node {nd} admitting {job}")
        alloc.append({"node": nd, "res": dict(res), "t": t})


def _replay_release(st8: Dict[str, Any], job: str, att,
                    t: Optional[float] = None) -> None:
    """Return one attempt's capacity and close its utilization
    intervals: the elapsed allocation becomes *busy* seconds
    immediately, and is parked in ``_util_pending`` until the job's
    terminal event decides whether it was *goodput* (the succeeding
    attempt) or lost work (everything else)."""
    pend = None
    for entry in st8["_alloc"].pop(f"{job}:{att}", []):
        res = entry["res"]
        info = st8["nodes"].get(entry["node"])
        if info is not None:
            used = info["used"]
            used["gpus"] = max(0, used["gpus"] - int(res.get("gpus") or 0))
            used["cpus"] = max(0, used["cpus"] - int(res.get("cpus") or 0))
            used["memory_gb"] = max(0.0, round(
                used["memory_gb"] - float(res.get("memory_gb") or 0.0), 6))
        u = st8["_util"].get(entry["node"])
        t0 = entry.get("t")
        if u is None or t0 is None or t is None:
            continue
        dt = max(0.0, float(t) - float(t0))
        gpu_s = dt * int(res.get("gpus") or 0)
        cpu_s = dt * int(res.get("cpus") or 0)
        u["busy_gpu_s"] += gpu_s
        u["busy_cpu_s"] += cpu_s
        if pend is None:
            pend = st8["_util_pending"].setdefault(job, [])
        pend.append({"attempt": str(att), "node": entry["node"],
                     "gpu_s": gpu_s, "cpu_s": cpu_s})


def _util_node_open(st8: Dict[str, Any], name: Optional[str],
                    d: Mapping[str, Any], t: Optional[float]) -> None:
    """A node entered (or re-entered) the inventory: start accruing its
    available capacity.  Draining nodes stay *available* — the hardware
    is still present and hosting residents — until removed."""
    if name is None:
        return
    u = st8["_util"].get(name)
    if u is None:
        u = st8["_util"][name] = {
            "gpus": 0, "cpus": 0, "open_t": None,
            "avail_gpu_s": 0.0, "avail_cpu_s": 0.0,
            "busy_gpu_s": 0.0, "busy_cpu_s": 0.0,
            "good_gpu_s": 0.0, "good_cpu_s": 0.0}
    u["gpus"] = int(d.get("gpus") or 0)
    u["cpus"] = int(d.get("cpus") or 0)
    if u["open_t"] is None and t is not None:
        u["open_t"] = float(t)


def _util_node_close(st8: Dict[str, Any], name: Optional[str],
                     t: Optional[float]) -> None:
    """A node left the inventory: bank its availability window.  The
    accumulated busy/goodput history is kept — removed nodes still
    appear in the ledger."""
    u = st8["_util"].get(name)
    if u is None or u["open_t"] is None or t is None:
        return
    dt = max(0.0, float(t) - u["open_t"])
    u["avail_gpu_s"] += dt * u["gpus"]
    u["avail_cpu_s"] += dt * u["cpus"]
    u["open_t"] = None


def _utilization_summary(st8: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Derive the per-node + cluster utilization ledger from the raw
    fold accumulators, virtually closing still-open availability and
    allocation intervals at the newest event time — WITHOUT mutating
    the fold state, so the incremental-fold property is preserved.

    ``busy`` counts every allocated second (useful or not); ``goodput``
    counts only seconds attributed to each job's succeeding attempt —
    busy minus goodput is work lost to preemption, eviction, timeouts,
    failures and speculation losses."""
    util = st8.get("_util") or {}
    if not util:
        return None
    t_end = st8.get("_t_hi")
    open_busy: Dict[str, Dict[str, float]] = {}
    if t_end is not None:
        for entries in (st8.get("_alloc") or {}).values():
            for e in entries:
                t0 = e.get("t")
                if t0 is None or e["node"] not in util:
                    continue
                dt = max(0.0, float(t_end) - float(t0))
                ob = open_busy.setdefault(
                    e["node"], {"gpu_s": 0.0, "cpu_s": 0.0})
                ob["gpu_s"] += dt * int(e["res"].get("gpus") or 0)
                ob["cpu_s"] += dt * int(e["res"].get("cpus") or 0)

    def frac(num: float, den: float) -> float:
        return round(num / den, 4) if den > 0 else 0.0

    nodes_out: Dict[str, Dict[str, float]] = {}
    tot = {k: 0.0 for k in ("avail_gpu", "busy_gpu", "good_gpu",
                            "avail_cpu", "busy_cpu", "good_cpu")}
    for name in sorted(util):
        u = util[name]
        avail_g, avail_c = u["avail_gpu_s"], u["avail_cpu_s"]
        if u["open_t"] is not None and t_end is not None:
            dt = max(0.0, float(t_end) - u["open_t"])
            avail_g += dt * u["gpus"]
            avail_c += dt * u["cpus"]
        ob = open_busy.get(name) or {}
        busy_g = u["busy_gpu_s"] + ob.get("gpu_s", 0.0)
        busy_c = u["busy_cpu_s"] + ob.get("cpu_s", 0.0)
        nodes_out[name] = {
            "available_gpu_s": round(avail_g, 4),
            "busy_gpu_s": round(busy_g, 4),
            "goodput_gpu_s": round(u["good_gpu_s"], 4),
            "busy_gpu_util": frac(busy_g, avail_g),
            "goodput_gpu_util": frac(u["good_gpu_s"], avail_g),
            "available_cpu_s": round(avail_c, 4),
            "busy_cpu_s": round(busy_c, 4),
            "goodput_cpu_s": round(u["good_cpu_s"], 4),
            "busy_cpu_util": frac(busy_c, avail_c),
            "goodput_cpu_util": frac(u["good_cpu_s"], avail_c),
        }
        tot["avail_gpu"] += avail_g
        tot["busy_gpu"] += busy_g
        tot["good_gpu"] += u["good_gpu_s"]
        tot["avail_cpu"] += avail_c
        tot["busy_cpu"] += busy_c
        tot["good_cpu"] += u["good_cpu_s"]
    cluster = {}
    for ax in ("gpu", "cpu"):
        cluster[f"available_{ax}_s"] = round(tot[f"avail_{ax}"], 4)
        cluster[f"busy_{ax}_s"] = round(tot[f"busy_{ax}"], 4)
        cluster[f"goodput_{ax}_s"] = round(tot[f"good_{ax}"], 4)
        cluster[f"busy_{ax}_util"] = frac(tot[f"busy_{ax}"],
                                          tot[f"avail_{ax}"])
        cluster[f"goodput_{ax}_util"] = frac(tot[f"good_{ax}"],
                                             tot[f"avail_{ax}"])
    return {"nodes": nodes_out, "cluster": cluster}


def _merge_telemetry(st: Dict[str, Any], summary: Dict[str, Any]) -> None:
    """Fold one attempt's telemetry summary into the job's aggregate:
    sample-weighted mean CPU%, max peak RSS/CPU, summed io."""
    prev = st.get("telemetry")
    if not prev:
        st["telemetry"] = dict(summary)
        return
    n0, n1 = prev.get("samples", 0), summary.get("samples", 0)
    tot = n0 + n1
    if tot:
        prev["cpu_pct_mean"] = round(
            (prev.get("cpu_pct_mean", 0.0) * n0
             + summary.get("cpu_pct_mean", 0.0) * n1) / tot, 2)
    prev["samples"] = tot
    for key in ("cpu_pct_peak", "rss_peak_mb"):
        prev[key] = max(prev.get(key) or 0.0, summary.get(key) or 0.0)
    for key in ("io_read_mb", "io_write_mb"):
        if summary.get(key) is not None:
            prev[key] = round((prev.get(key) or 0.0) + summary[key], 3)


def _observed_ratio(st: Dict[str, Any]) -> Optional[Dict[str, float]]:
    tel, dec = st.get("telemetry"), st.get("declared")
    if not tel or not dec:
        return None
    out = {}
    if dec.get("cpus") and tel.get("cpu_pct_peak") is not None:
        out["cpus"] = round(tel["cpu_pct_peak"] / 100.0 / dec["cpus"], 3)
    if dec.get("memory_gb") and tel.get("rss_peak_mb") is not None:
        out["memory"] = round(
            tel["rss_peak_mb"] / 1024.0 / dec["memory_gb"], 3)
    return out or None


def replay_events(lines, *, state: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Replay an event log into campaign state.  Accepts an iterable of
    JSONL lines (or parsed dicts).  Half-written trailing lines (a crash
    mid-append) are skipped; when the log holds several campaigns
    (appended runs), a ``campaign_start`` resets state so the **last**
    campaign wins, while ``campaign_resume`` continues the current one.

    Replay is an incremental fold: pass a previously returned ``state``
    to continue it over new lines — ``replay_events(A + B)`` equals
    ``replay_events(B, state=replay_events(A))`` for any line-aligned
    split (the replay-idempotence property tests assert exactly this).
    The passed state is not mutated.

    Returns ``{"jobs": {name: {...}}, "counts": {...}, "workers",
    "ended", "makespan_s", "resumes", "utilization", "consistent",
    "violations"}`` — ``utilization`` is the per-node + cluster
    area-under-curve ledger (busy vs goodput GPU/CPU seconds over
    elastic availability windows), or ``None`` for inventory-less
    logs; ``consistent`` asserts the executor's bookkeeping invariants:
    monotonic per-job states, one terminal event per job, and (for ended
    campaigns) no non-terminal jobs left behind.  Per-job state includes
    orphan bookkeeping (``live`` pids), speculation and telemetry
    aggregates, and the declared-vs-observed request ratio.
    """
    if state is None:
        st8 = _fresh_replay_state()
    else:                            # continue without mutating caller's
        st8 = json.loads(json.dumps(
            {k: state[k] for k in _fresh_replay_state() if k in state},
            default=str))
        for miss, dflt in _fresh_replay_state().items():
            st8.setdefault(miss, dflt)
    jobs = st8["jobs"]
    violations = st8["violations"]

    for ln in lines:
        if isinstance(ln, (bytes, str)):
            ln = ln.strip()
            if not ln:
                continue
            try:
                ln = json.loads(ln)
            except ValueError:
                continue             # half-written trailing line
        if not isinstance(ln, dict):
            continue
        kind = ln.get("event")
        t_ev = ln.get("t")
        # newest event time drives the ledger's virtual horizon; the
        # campaign_end stamp is excluded so the executor's own summary
        # (written just before campaign_end) matches a later replay
        if (kind not in ("campaign_end", "campaign_start")
                and isinstance(t_ev, (int, float))):
            if st8["_t_hi"] is None or t_ev > st8["_t_hi"]:
                st8["_t_hi"] = float(t_ev)
        if kind == "campaign_start":     # newest campaign wins: reset
            st8["jobs"] = jobs = {}
            st8["violations"] = violations = []
            st8.update(workers=ln.get("workers"), ended=False,
                       makespan_s=None, resumes=0,
                       nodes={d["name"]: _node_entry(d)
                              for d in ln.get("inventory") or []},
                       _alloc={}, _util={}, _util_pending={},
                       _t_hi=float(t_ev)
                       if isinstance(t_ev, (int, float)) else None)
            for d in ln.get("inventory") or []:
                _util_node_open(st8, d.get("name"), d, st8["_t_hi"])
            continue
        if kind == "campaign_resume":
            st8["workers"] = ln.get("workers", st8["workers"])
            st8["ended"] = False
            st8["resumes"] += 1
            # the dead scheduler left allocation intervals open: close
            # them here (busy up to the resume stamp); adopted attempts
            # are re-charged below and keep accruing
            for key in list(st8["_alloc"]):
                jb, _, at = key.rpartition(":")
                _replay_release(st8, jb, at, t_ev)
            # the resuming scheduler built a fresh pool: restart the
            # node accounting (adopted events re-charge live orphans)
            # and reconcile node availability windows — nodes absent
            # from the new inventory stop accruing, new ones start
            new_names = {d.get("name") for d in ln.get("inventory") or []}
            for nm in list(st8["_util"]):
                if nm not in new_names:
                    _util_node_close(st8, nm, t_ev)
            st8["nodes"] = {d["name"]: _node_entry(d)
                            for d in ln.get("inventory") or []}
            st8["_alloc"] = {}
            for d in ln.get("inventory") or []:
                _util_node_open(st8, d.get("name"), d, t_ev)
            # re-charge attempts the resuming scheduler adopted (their
            # `adopted` events precede this line in the log)
            for la in ln.get("live_allocs") or []:
                _replay_allocate(st8, violations, la.get("job"),
                                 la.get("attempt"),
                                 la.get("placements") or [],
                                 la.get("resources") or {}, t_ev)
            continue
        if kind == "campaign_end":
            st8["ended"] = True
            st8["makespan_s"] = ln.get("makespan_s")
            continue
        if kind == "node_added":
            st8["nodes"][ln.get("node")] = _node_entry(ln)
            _util_node_open(st8, ln.get("node"), ln, t_ev)
            continue
        if kind == "node_draining":
            info = st8["nodes"].get(ln.get("node"))
            if info is not None:
                info["draining"] = True
            continue
        if kind == "node_undrained":
            info = st8["nodes"].get(ln.get("node"))
            if info is not None:
                info["draining"] = False
            continue
        if kind == "node_removed":
            info = st8["nodes"].pop(ln.get("node"), None)
            if info is not None and (info["used"]["gpus"]
                                     or info["used"]["cpus"]
                                     or info["used"]["memory_gb"] > 1e-6):
                violations.append(
                    f"node {ln.get('node')} removed with residents")
            _util_node_close(st8, ln.get("node"), t_ev)
            continue
        name = ln.get("job")
        if name is None:
            continue
        st = jobs.get(name)
        if st is None:
            st = jobs[name] = _new_job_state()
        for missing, dflt in _new_job_state().items():
            st.setdefault(missing, dflt)
        att = ln.get("attempt")
        if kind == "submitted":
            st["priority"] = ln.get("priority", 0)
            st["kind"] = ln.get("kind")
            if st["gang_shrunk_from"] is None:
                # an initial-pre-pass gang_shrunk precedes submitted;
                # the declared size must not clobber the shrunk one
                st["gang"] = int(ln.get("gang") or 1)
            if ln.get("resources"):
                st["declared"] = ln["resources"]
        elif kind == "admitted":
            if st["state"] in ("Succeeded", "Failed"):
                violations.append(f"{name}: admitted after terminal state")
            st["state"] = "Running"
            st["node"] = ln.get("node")
            if not ln.get("speculative"):
                st["attempts"] = max(st["attempts"], int(att or 0))
            if ln.get("backfill"):
                st["backfills"] += 1
            _replay_allocate(st8, violations, name, att,
                             ln.get("placements")
                             or ([ln.get("node")] if ln.get("node")
                                 else []),
                             ln.get("resources") or {}, t_ev)
        elif kind == "started":
            entry = {"pid": ln.get("pid"),
                     "pid_start": ln.get("pid_start"),
                     "t": ln.get("t"),
                     "speculative": bool(ln.get("speculative")),
                     "ckpt_dir": ln.get("ckpt_dir")}
            if ln.get("ranks"):
                # gang attempt: remember every rank's pid (resume must
                # kill them all) and reset per-rank exit bookkeeping
                entry["ranks"] = ln["ranks"]
                st["gang"] = int(ln.get("gang") or len(ln["ranks"]))
                st["gang_id"] = ln.get("gang_id")
                st["ranks"] = {
                    str(rk.get("rank")): {"pid": rk.get("pid"),
                                          "returncode": None}
                    for rk in ln["ranks"]}
            st["live"][str(att)] = entry
            if ln.get("speculative"):
                st["speculative_launches"] += 1
        elif kind == "rank_exited":
            rk = st["ranks"].setdefault(str(ln.get("rank")),
                                        {"pid": None, "returncode": None})
            rk["returncode"] = ln.get("returncode")
        elif kind == "adopted":
            st["state"] = "Running"
            st["adoptions"] += 1
            st["live"][str(att)] = {
                "pid": ln.get("pid"), "pid_start": ln.get("pid_start"),
                "t": ln.get("t"), "speculative": False,
                "ckpt_dir": ln.get("ckpt_dir")}
            # adoption MOVES the attempt's charge (the old campaign's
            # admitted line already holds one, possibly on another node)
            _replay_release(st8, name, att, t_ev)
            _replay_allocate(st8, violations, name, att,
                             [ln.get("node")] if ln.get("node") else [],
                             ln.get("resources") or {}, t_ev,
                             check=False)
        elif kind == "orphan_requeued":
            st["live"].pop(str(att), None)
            _replay_release(st8, name, att, t_ev)
            if st["state"] == "Running":
                st["state"] = "Pending"
        elif kind == "orphan_killed":
            st["live"].pop(str(att), None)
            _replay_release(st8, name, att, t_ev)
        elif kind == "exited":
            st["live"].pop(str(att), None)
            st["_last_exit_wall"] = ln.get("wall_s")
            _replay_release(st8, name, att, t_ev)
        elif kind == "evicted":
            st["evictions"] += 1
            if ln.get("requeued") and st["state"] == "Running":
                st["state"] = "Pending"
        elif kind == "gang_shrunk":
            if st["gang_shrunk_from"] is None:
                st["gang_shrunk_from"] = ln.get("gang_from")
            st["gang"] = int(ln.get("gang_to") or st["gang"])
        elif kind == "chaos_kill":
            st["chaos_kills"] += 1
        elif kind == "preempted":
            st["preemptions"] += 1
        elif kind == "attempt_timeout":
            st["timeouts"] += 1
        elif kind == "speculation_win":
            st["winner_ckpt_dir"] = ln.get("winner_ckpt_dir")
        elif kind == "speculation_promote":
            st["promoted"] = True
        elif kind == "speculation_loss":
            st["speculation_losses"] += 1
            st["speculation_loss_wall_s"] = round(
                st["speculation_loss_wall_s"] + (ln.get("wall_s") or 0.0),
                3)
            st["live"].pop(str(att), None)
        elif kind == "telemetry":
            if ln.get("summary"):
                _merge_telemetry(st, ln["summary"])
                st["declared_vs_observed"] = _observed_ratio(st)
        elif kind in TERMINAL_EVENTS:
            if st["state"] in ("Succeeded", "Failed"):
                violations.append(f"{name}: second terminal event {kind}")
            st["state"] = "Failed" if kind != "succeeded" else "Succeeded"
            # classify the job's parked busy intervals: only the
            # succeeding attempt's seconds count as goodput; every
            # other attempt (and a failed job entirely) was lost work
            pend = st8["_util_pending"].pop(name, [])
            if kind == "succeeded":
                st["resumed_from_step"] = ln.get("resumed_from_step")
                st["succeeded_wall_s"] = st.get("_last_exit_wall")
                att_s = None if att is None else str(att)
                for e in pend:
                    if att_s is not None and e["attempt"] != att_s:
                        continue
                    u = st8["_util"].get(e["node"])
                    if u is not None:
                        u["good_gpu_s"] += e["gpu_s"]
                        u["good_cpu_s"] += e["cpu_s"]
            else:
                st["error"] = ln.get("error")

    counts: Dict[str, int] = {}
    for st in jobs.values():
        counts[st["state"]] = counts.get(st["state"], 0) + 1
    all_viol = list(violations)
    if st8["ended"]:
        nonterminal = [n for n, st in jobs.items()
                       if st["state"] not in ("Succeeded", "Failed")]
        if nonterminal:
            all_viol.append(
                f"campaign ended with non-terminal jobs: {nonterminal}")
    return {**st8, "jobs": jobs, "counts": counts,
            "utilization": _utilization_summary(st8),
            "consistent": not all_viol, "violations": all_viol}


# --------------------------------------------------------------------------
# The executor
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Running:
    rec: JobRecord
    attempt: int                     # per-job attempt seq (incl. duplicates)
    node: str
    handle: Any
    stdout_path: Path
    stderr_path: Path
    stdout_fh: Optional[IO]
    stderr_fh: Optional[IO]
    started_t: float
    resume: bool
    cores: List[int] = dataclasses.field(default_factory=list)
    eff: Optional[Resources] = None  # learned request admitted/released with
    speculative: bool = False
    spec_loser: bool = False         # a sibling won; kill was ours to eat
    timed_out: bool = False
    adopted: bool = False
    # graceful-kill escalation: SIGTERM sent at term_t, SIGKILL once the
    # grace window expires.  `evicted` marks evictions/drains — their
    # requeue consumes no retry budget and triggers no backoff.
    term_t: Optional[float] = None
    kill_reason: Optional[str] = None
    escalated: bool = False
    evicted: bool = False
    ckpt_dir: Optional[str] = None
    telem: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # gang attempts: one _Running covers all ranks (handle is a
    # _GangHandle); `placements` lists every rank's node (incl. `node`,
    # which is rank 0's) and `aux_fhs` the non-rank-0 log handles
    gang: int = 1
    gang_id: Optional[str] = None
    placements: List[str] = dataclasses.field(default_factory=list)
    aux_fhs: List[IO] = dataclasses.field(default_factory=list)


class CampaignExecutor:
    """Run a campaign's pending jobs as concurrent subprocesses.

    Parameters
    ----------
    records:    the orchestrator's ``{name: JobRecord}`` (mutated in
                place — states, attempts, results, telemetry).
    pvc:        :class:`PersistentVolume` for logs/results/events.
    s3:         optional :class:`S3Store`; succeeded results are exported.
    workers:    max concurrent subprocesses.
    inventory:  :class:`NodeSpec` sequence gating admission; default:
                :func:`local_inventory` (one max-request node per worker).
    chaos:      optional :class:`ChaosSpec` fault injection.
    worker_env: extra env vars for every subprocess (e.g. pinning each
                worker to one CPU thread for benchmark determinism).
    pin_cpus:   enforce the job's ``Resources.cpus`` request as a real
                CPU-affinity limit (the local analogue of a Kubernetes
                CPU limit): each worker slot gets a round-robin core set
                of that size, exported as ``REPRO_CPU_AFFINITY`` and
                applied by ``repro_torch.launch`` before torch loads.  Linux
                only; silently off elsewhere.
    python:     interpreter for subprocesses (default ``sys.executable``).
    spawn:      injectable process factory for tests.
    attempt_timeout_s: kill attempts that exceed this wall time (its own
                ``timeout`` outcome, counted into preemptions and lost
                wall; retries still apply).
    resume:     replay an existing event log before scheduling: completed
                jobs are marked done (never re-executed), still-alive
                orphan attempts are re-adopted by pid + start-time
                identity, dead orphans re-queue through the retry_env
                resume path.
    speculate:  ``True`` (defaults) or a :class:`SpeculationSpec` —
                launch first-finisher-wins duplicates for stragglers.
    backfill:   allow jobs behind a blocked queue head to use capacity
                the head cannot, under the no-head-delay bound.  Off by
                default: admission is strict head-of-line within
                (-priority, submit order) among jobs not in backoff.
    telemetry:  sample per-attempt CPU%/RSS/io from /proc into the event
                log and feed completed usage to the learned-request
                model (``telemetry_every_s`` cadence; ``telemetry_log_-
                every_s`` rate-limits per-attempt sample events).
    retry_backoff_base_s / retry_backoff_cap_s / backoff_seed:
                exponential backoff with deterministic full jitter
                between *failure/timeout* retries (signal preemptions
                requeue immediately — a preempted pod is not the job's
                fault).  ``base * 2**(nfail-1)`` capped, scaled by
                ``0.5 + 0.5*rng()``.  ``base=0`` disables.
    clock:      injectable wall clock (``time.time``) — all event
                timestamps, backoff gates and timeout checks use it.
    straggler_env: ``{job_name: {env}}`` overlay applied only to the
                job's *primary* attempts (a degraded node in miniature:
                duplicates escape it — used by the straggler bench).
    learned:    injectable :class:`LearnedRequests` model.
    progress_fn: injectable ``(run, now) -> steps/s | None`` probe
                (default: newest published checkpoint manifest).
    """

    def __init__(self, records: Dict[str, JobRecord],
                 pvc: PersistentVolume, s3: Optional[S3Store] = None, *,
                 workers: int = 1,
                 inventory: Optional[Sequence[NodeSpec]] = None,
                 chaos: Optional[ChaosSpec] = None,
                 worker_env: Optional[Mapping[str, str]] = None,
                 pin_cpus: bool = False,
                 python: Optional[str] = None,
                 spawn: Optional[Callable] = None,
                 attempt_timeout_s: Optional[float] = None,
                 poll_s: float = 0.05,
                 grace_s: float = 5.0,
                 preempt: bool = False,
                 nodes_file: Optional[Union[str, Path]] = None,
                 resume: bool = False,
                 speculate: Union[bool, SpeculationSpec] = False,
                 backfill: bool = False,
                 telemetry: bool = True,
                 telemetry_every_s: float = 0.5,
                 telemetry_log_every_s: float = 2.0,
                 retry_backoff_base_s: float = 1.0,
                 retry_backoff_cap_s: float = 30.0,
                 backoff_seed: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 straggler_env: Optional[Mapping[str, Mapping[str, str]]]
                 = None,
                 learned: Optional[LearnedRequests] = None,
                 progress_fn: Optional[Callable] = None,
                 placement: Union[str, Any, None] = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.records = records
        self.pvc = pvc
        self.s3 = s3
        self.workers = int(workers)
        self.chaos = chaos
        self.worker_env = dict(worker_env or {})
        self.python = python or sys.executable
        self.spawn = spawn or _default_spawn
        self.attempt_timeout_s = attempt_timeout_s
        self.poll_s = poll_s
        self.grace_s = float(grace_s)
        self.preempt = preempt
        self.resume = resume
        if speculate is True:
            self.speculate: Optional[SpeculationSpec] = SpeculationSpec()
        else:
            self.speculate = speculate or None
        self.backfill = backfill
        self.telemetry = telemetry
        self.telemetry_every_s = telemetry_every_s
        self.telemetry_log_every_s = telemetry_log_every_s
        self.retry_backoff_base_s = retry_backoff_base_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        self._backoff_rng = random.Random(backoff_seed)
        self.clock = clock or time.time
        self.straggler_env = {k: dict(v)
                              for k, v in (straggler_env or {}).items()}
        self.learned = learned if learned is not None else LearnedRequests()
        self.progress_fn = progress_fn or checkpoint_progress
        pending = [r for r in records.values() if r.state == JobState.PENDING]
        self._order = {r.spec.name: i for i, r in enumerate(pending)}
        # elastic inventory: campaign/nodes.json (or an explicit
        # nodes_file) is watched every poll tick — rewrite it to grow or
        # drain+remove nodes mid-campaign.  When it exists up front and
        # no inventory was passed, it also *is* the initial inventory.
        self._nodes_file = (Path(nodes_file) if nodes_file
                            else pvc.path("campaign/nodes.json"))
        self._nodes_mtime: Optional[int] = None
        if inventory is None and self._nodes_file.exists():
            from repro_torch.core.scheduler import node_specs_from_json
            try:
                inventory = node_specs_from_json(
                    json.loads(self._nodes_file.read_text()))
                self._nodes_mtime = self._nodes_file.stat().st_mtime_ns
            except (OSError, ValueError, TypeError, KeyError):
                inventory = None
        self.pool = ResourcePool(inventory if inventory is not None
                                 else local_inventory(workers,
                                                      [r.spec for r in pending]),
                                 policy=placement)
        self.pin_cpus = pin_cpus and hasattr(os, "sched_getaffinity")
        self._host_cpus = (sorted(os.sched_getaffinity(0))
                           if self.pin_cpus else [])
        # per-core count of running pinned attempts: new attempts take
        # the least-loaded cores, so concurrent jobs spread across the
        # host instead of stacking on one core
        self._core_load: Dict[int, int] = {c: 0 for c in self._host_cpus}
        self.log = EventLog(pvc.path(EVENTS_REL), clock=self.clock)
        # per-job bookkeeping
        self._queue: List[JobRecord] = list(pending)
        self._running: List[_Running] = []
        self._run_lock = threading.Lock()   # sampler thread reads _running
        self._attempt_history: Dict[str, List[dict]] = {}
        self._attempt_seq: Dict[str, int] = {}
        self._chaos_kills: Dict[str, int] = {}
        self._queued_t: Dict[str, float] = {}
        self._not_before: Dict[str, float] = {}
        self._nfail: Dict[str, int] = {}
        self._spec_count: Dict[str, int] = {}
        # effective gang size per job (elastic gangs shrink it, floor
        # JobSpec.gang_min) and requeues that consume no retry budget
        self._gang_now: Dict[str, int] = {}
        self._free_requeues: Dict[str, int] = {}
        self._evict_signals = 0
        self._nodes_added = 0
        self._nodes_drained = 0
        self._nodes_removed = 0
        self._kind_rates: Dict[str, List[float]] = {}
        self._kind_walls: Dict[str, List[float]] = {}
        self._pending_promote: Dict[str, Tuple[str, str]] = {}
        self._spec_launches = 0
        self._spec_wins = 0
        self._spec_wall_lost = 0.0
        self._backfills = 0
        self._adopted = 0
        self._orphans_requeued = 0
        self._resumed_done = 0
        self.queue_waits: List[float] = []
        self.summary: Dict[str, Any] = {}
        try:
            self._clk_tck = os.sysconf("SC_CLK_TCK")
        except (ValueError, OSError, AttributeError):
            self._clk_tck = 100
        self._stop = threading.Event()
        self._sampler: Optional[threading.Thread] = None

    # ------------------------------------------------------------ helpers
    def _sort_queue(self) -> None:
        self._queue.sort(key=lambda r: (-r.spec.priority,
                                        self._order[r.spec.name]))

    def _child_env(self) -> Dict[str, str]:
        env = {**os.environ, **self.worker_env}
        src = _src_path()
        existing = env.get("PYTHONPATH", "")
        if src not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (src + os.pathsep + existing
                                 if existing else src)
        return env

    def _checkpoint_dir(self, job: JobSpec) -> Optional[str]:
        return job.env.get("CHECKPOINT_DIR")

    def _job_kind(self, job: JobSpec) -> str:
        return (f"{job.env.get('RUN_KIND', '?')}:"
                f"{job.env.get('ARCH', '')}")

    def _effective(self, job: JobSpec) -> Resources:
        return self.learned.effective(self._job_kind(job), job.resources)

    def _est_wall(self, kind: str) -> Optional[float]:
        walls = self._kind_walls.get(kind)
        return sum(walls) / len(walls) if walls else None

    def _procs_running(self) -> int:
        """Concurrent subprocess count — the worker cap's unit.  A gang
        attempt holds one _Running but `gang` processes."""
        with self._run_lock:
            return sum(max(1, r.gang) for r in self._running)

    def _gang(self, job: JobSpec) -> int:
        """The job's *effective* gang size: the declared world unless an
        elastic shrink picked a smaller admissible one."""
        return self._gang_now.get(job.name, max(1, job.gang))

    # ------------------------------------------------- graceful preemption
    def _graceful_kill(self, run: _Running, now: float, reason: str, *,
                       evict: bool = False) -> None:
        """The shared SIGTERM -> grace -> SIGKILL escalation (Kubernetes
        pod-preemption semantics).  SIGTERM goes out now; the child's
        handler writes a final checkpoint and exits; the poll loop
        escalates to SIGKILL if the attempt outlives ``grace_s``.  Used
        by the evictor, node drains, speculation-loser kills, and
        non-SIGKILL chaos."""
        if run.term_t is not None or run.timed_out:
            return
        run.term_t = now
        run.kill_reason = reason
        if evict:
            run.evicted = True
        run.handle.send_signal(int(_signal.SIGTERM))

    def _escalate_overdue(self, run: _Running, now: float) -> None:
        if (run.term_t is None or run.escalated
                or now - run.term_t < self.grace_s):
            return
        run.escalated = True
        self.log.emit("grace_expired", job=run.rec.spec.name,
                      attempt=run.attempt, reason=run.kill_reason,
                      grace_s=self.grace_s)
        run.handle.send_signal(int(_signal.SIGKILL))

    # ------------------------------------------------- elastic inventory
    def _check_nodes_file(self, now: float) -> None:
        """Apply a rewritten ``campaign/nodes.json``: grow with new
        nodes, drain+remove missing ones.  Torn/partial writes are
        retried on the next poll tick (writers should publish via
        tmp+rename)."""
        try:
            mtime = self._nodes_file.stat().st_mtime_ns
        except OSError:
            return
        if mtime == self._nodes_mtime:
            return
        from repro_torch.core.scheduler import node_specs_from_json
        try:
            specs = node_specs_from_json(
                json.loads(self._nodes_file.read_text()))
        except (OSError, ValueError, TypeError, KeyError):
            return
        self._nodes_mtime = mtime
        self._apply_inventory(specs, now)

    def _apply_inventory(self, specs: Sequence[NodeSpec],
                         now: float) -> None:
        desired: Dict[str, NodeSpec] = {}
        for spec in specs:
            for i in range(max(1, spec.count)):
                desired[f"{spec.name}-{i:03d}"] = \
                    dataclasses.replace(spec, count=1)
        current = {n.name: n for n in self.pool.nodes}
        for name, spec in desired.items():
            node = current.get(name)
            if node is None:
                self.pool.add_node(spec, name)
                self._nodes_added += 1
                self.log.emit("node_added", node=name, gpus=spec.gpus,
                              cpus=spec.cpus, memory_gb=spec.memory_gb,
                              gpu_memory_gb=spec.gpu_memory_gb)
            elif node.draining:
                # re-added before the drain completed: cancel it
                node.draining = False
                self.log.emit("node_undrained", node=name)
        for name, node in current.items():
            if name in desired or node.draining:
                continue
            self.pool.drain(name)
            self._nodes_drained += 1
            with self._run_lock:
                residents = [r for r in self._running
                             if name in (r.placements or [r.node])]
            self.log.emit("node_draining", node=name,
                          residents=sorted({r.rec.spec.name
                                            for r in residents}))
            for r in residents:
                # the whole attempt leaves (a gang loses its rank here
                # and condemns itself): grace window to checkpoint,
                # then a free requeue
                self._graceful_kill(r, now, "drain", evict=True)
        self._reap_drained()
        self._recheck_schedulable(now)

    def _reap_drained(self) -> None:
        for name in self.pool.drained_free():
            self.pool.remove_node(name)
            self._nodes_removed += 1
            self.log.emit("node_removed", node=name)

    # ------------------------------------------ schedulability + shrink
    def _ensure_placeable(self, rec: JobRecord, now: float, *,
                          initial: bool = False) -> bool:
        """Could this queued job ever be admitted at the current
        inventory?  Elastic gangs (1 <= gang_min < gang) shrink to the
        largest admissible world instead of failing; rigid jobs that fit
        nothing are failed as unschedulable.  During a full drain (no
        admitting nodes) non-initial checks wait instead of failing —
        capacity may be about to grow back."""
        job = rec.spec
        gang = self._gang(job)
        admitting = any(not n.draining for n in self.pool.nodes)
        if gang > 1:
            if (gang <= self.workers
                    and self.pool.fits_when_empty_gang(job.resources,
                                                       gang)):
                return True
            gmin = int(getattr(job, "gang_min", 0) or 0)
            if 1 <= gmin < gang:
                for n in range(min(gang - 1, self.workers), gmin - 1, -1):
                    if self.pool.fits_when_empty_gang(job.resources, n):
                        self._gang_now[job.name] = n
                        self.log.emit("gang_shrunk", job=job.name,
                                      gang_from=gang, gang_to=n,
                                      gang_min=gmin)
                        return True
            if not admitting and not initial:
                return True              # wait out the resize
            self._queue.remove(rec)
            rec.state = JobState.FAILED
            rec.error = (
                f"unschedulable: gang of {gang} ranks x "
                f"{job.resources.cpus} cpus/"
                f"{job.resources.memory_gb:g}GB cannot be "
                f"placed atomically (workers={self.workers})"
                if gang <= self.workers else
                f"unschedulable: gang of {gang} ranks exceeds "
                f"worker cap {self.workers}")
            self.log.emit("unschedulable", job=job.name, gang=gang,
                          error=rec.error)
            self._stage_result(rec)
            return False
        if self.pool.fits_when_empty(job.resources):
            return True
        if not admitting and not initial:
            return True
        self._queue.remove(rec)
        rec.state = JobState.FAILED
        rec.error = ("unschedulable: resource request fits no "
                     "node in the inventory")
        self.log.emit("unschedulable", job=job.name, error=rec.error)
        self._stage_result(rec)
        return False

    def _recheck_schedulable(self, now: float) -> None:
        for rec in list(self._queue):
            self._ensure_placeable(rec, now)

    # ----------------------------------------------------------- evictor
    def _head_placeable_after(self, victims: Sequence[_Running],
                              head_eff: Resources, head_gang: int,
                              procs_free: int) -> bool:
        """Would releasing ``victims`` let the queue head start?  Pure
        simulation on a pool clone — nothing is killed here."""
        if procs_free + sum(max(1, v.gang) for v in victims) < head_gang:
            return False
        trial = self.pool.clone()
        for v in victims:
            for placement in (v.placements or [v.node]):
                trial.release(placement, v.eff or v.rec.spec.resources)
        if head_gang > 1:
            return trial.admit_gang(head_eff, head_gang) is not None
        return trial.admit(head_eff) is not None

    def _maybe_evict(self, now: float) -> None:
        """Preempting scheduler class: when the queue head outranks
        running work and cannot be placed, evict (checkpoint + requeue,
        no retry consumed) the cheapest set of strictly-lower-priority
        attempts whose release makes the head placeable."""
        if not self.preempt or not self._queue:
            return
        eligible = [r for r in self._queue
                    if self._not_before.get(r.spec.name, 0.0) <= now]
        if not eligible:
            return
        head = eligible[0]
        head_gang = self._gang(head.spec)
        head_eff = self._effective(head.spec)
        with self._run_lock:
            running = list(self._running)
        victims = [r for r in running
                   if r.rec.spec.priority < head.spec.priority
                   and r.term_t is None and not r.timed_out]
        if not victims:
            return
        procs_free = self.workers - self._procs_running()
        if self._head_placeable_after([], head_eff, head_gang,
                                      procs_free):
            return                       # head is placeable on its own
        # lowest priority first; speculative duplicates before primaries
        # (cheapest to lose); newest first within a class (least sunk
        # work thrown away)
        victims.sort(key=lambda r: (r.rec.spec.priority,
                                    0 if r.speculative else 1,
                                    -r.started_t))
        chosen: List[_Running] = []
        for v in victims:
            chosen.append(v)
            if self._head_placeable_after(chosen, head_eff, head_gang,
                                          procs_free):
                break
        else:
            return                       # even all victims don't free enough
        # back-trim: drop any victim whose release turned out unneeded
        if len(chosen) > 1:
            for v in list(chosen):
                rest = [r for r in chosen if r is not v]
                if self._head_placeable_after(rest, head_eff, head_gang,
                                              procs_free):
                    chosen = rest
        for v in chosen:
            self._evict_signals += 1
            self.log.emit("evict", job=v.rec.spec.name,
                          attempt=v.attempt,
                          victim_priority=v.rec.spec.priority,
                          head=head.spec.name,
                          head_priority=head.spec.priority,
                          speculative=v.speculative)
            self._graceful_kill(v, now, "evict", evict=True)

    # ---------------------------------------------------------- lifecycle
    def _start_attempt(self, rec: JobRecord, node: str, now: float, *,
                       eff: Resources, speculative: bool = False,
                       placements: Optional[List[str]] = None) -> None:
        job = rec.spec
        gang = 1 if speculative else self._gang(job)
        seq = self._attempt_seq.get(job.name, 0) + 1
        self._attempt_seq[job.name] = seq
        if not speculative:
            rec.attempts += 1
        resume = (not speculative and rec.attempts > 1
                  and bool(job.retry_env))
        ckpt = self._checkpoint_dir(job)
        overlay: Optional[Dict[str, str]] = None
        if speculative and ckpt:
            # the duplicate races in a sibling dir; the winner's dir is
            # promoted to the declared path on first finish
            ckpt = f"{ckpt}.spec{seq}"
            overlay = {"CHECKPOINT_DIR": ckpt}
        if not speculative and gang != max(1, job.gang):
            # elastic shrink: the child re-derives its world size from
            # the env overlay; the rank-agnostic checkpoint makes the
            # resume a pure re-placement
            overlay = dict(overlay or {})
            overlay["WORLD_SIZE"] = str(gang)
        argv = ([self.python, "-m", "repro_torch.launch"]
                + job_run_argv(job, resume=resume, env_overlay=overlay))
        env = self._child_env()
        if not speculative and job.name in self.straggler_env:
            env.update(self.straggler_env[job.name])
        cores: List[int] = []
        if self.pin_cpus and self._host_cpus:
            # the Resources.cpus request becomes a real affinity limit:
            # take the currently least-loaded cores (released when the
            # attempt exits), so concurrent jobs spread across the host.
            # A gang's ranks share one core set sized to the gang total.
            need = max(1, min(job.resources.cpus * gang,
                              len(self._host_cpus)))
            cores = sorted(self._host_cpus,
                           key=lambda c: (self._core_load[c], c))[:need]
            for c in cores:
                self._core_load[c] += 1
            env["REPRO_CPU_AFFINITY"] = ",".join(str(c) for c in cores)
        gang_id: Optional[str] = None
        rank_meta: List[Dict[str, Any]] = []
        aux_fhs: List[IO] = []
        if gang > 1:
            # one subprocess per rank, all admitted already (placements);
            # rank 0 hosts the torch.distributed rendezvous and its log
            # carries the gang's RunReport
            from repro_torch.distributed.gang import free_port, rank_argv
            coordinator = f"127.0.0.1:{free_port()}"
            gang_id = f"{job.name}.g{seq}"
            procs: List[Any] = []
            out_p = err_p = None
            out_fh = err_fh = None
            for r in range(gang):
                o_p = self.pvc.path(
                    f"logs/{job.name}.attempt{seq}.rank{r}.out")
                e_p = self.pvc.path(
                    f"logs/{job.name}.attempt{seq}.rank{r}.err")
                o_p.parent.mkdir(parents=True, exist_ok=True)
                ofh, efh = open(o_p, "wb"), open(e_p, "wb")
                child = self.spawn(job, seq,
                                   rank_argv(argv, r, coordinator),
                                   env, ofh, efh)
                procs.append(child)
                cpid = getattr(child, "pid", None)
                rank_meta.append({
                    "rank": r, "pid": cpid,
                    "pid_start": _pid_start_time(cpid) if cpid else None})
                if r == 0:
                    out_p, err_p, out_fh, err_fh = o_p, e_p, ofh, efh
                else:
                    aux_fhs.extend((ofh, efh))

            def _rank_exited(rank: int, rc: int,
                             _name=job.name, _seq=seq, _gid=gang_id):
                self.log.emit("rank_exited", job=_name, attempt=_seq,
                              gang_id=_gid, rank=rank, returncode=rc)

            handle: Any = _GangHandle(procs, on_rank_exit=_rank_exited,
                                      grace_s=self.grace_s,
                                      clock=self.clock)
        else:
            out_p = self.pvc.path(f"logs/{job.name}.attempt{seq}.out")
            err_p = self.pvc.path(f"logs/{job.name}.attempt{seq}.err")
            out_p.parent.mkdir(parents=True, exist_ok=True)
            out_fh = open(out_p, "wb")
            err_fh = open(err_p, "wb")
            handle = self.spawn(job, seq, argv, env, out_fh, err_fh)
        run = _Running(
            rec=rec, attempt=seq, node=node, handle=handle,
            stdout_path=out_p, stderr_path=err_p,
            stdout_fh=out_fh, stderr_fh=err_fh,
            started_t=now, resume=resume, cores=cores, eff=eff,
            speculative=speculative, ckpt_dir=ckpt,
            gang=gang, gang_id=gang_id,
            placements=list(placements or [node]), aux_fhs=aux_fhs)
        with self._run_lock:
            self._running.append(run)
        pid = getattr(handle, "pid", None)
        self.log.emit("started", job=job.name, attempt=seq, pid=pid,
                      pid_start=_pid_start_time(pid) if pid else None,
                      resume=resume, node=node, speculative=speculative,
                      ckpt_dir=ckpt,
                      **({"gang": gang, "gang_id": gang_id,
                          "ranks": rank_meta} if gang > 1 else {}))

    def _admit(self, rec: JobRecord, node: str, now: float, *,
               eff: Resources, backfill: bool = False,
               head: Optional[str] = None,
               head_bound: Optional[float] = None,
               placements: Optional[List[str]] = None) -> None:
        self._queue.remove(rec)
        wait = now - self._queued_t.get(rec.spec.name, now)
        if rec.attempts == 0:            # PENDING -> RUNNING once
            rec.state = JobState.RUNNING
            self.queue_waits.append(wait)
        if rec.start_time is None:
            rec.start_time = now
        rec.state = JobState.RUNNING
        fields: Dict[str, Any] = dict(
            job=rec.spec.name, node=node,
            attempt=self._attempt_seq.get(rec.spec.name, 0) + 1,
            queue_wait_s=round(wait, 3),
            resources={"gpus": eff.gpus, "cpus": eff.cpus,
                       "memory_gb": eff.memory_gb})
        gang = self._gang(rec.spec)
        if gang > 1 or rec.spec.gang > 1:
            fields.update(gang=gang, placements=placements,
                          gang_nodes=len(set(placements or [node])))
        if eff is not rec.spec.resources:
            fields["learned_request"] = {"cpus": eff.cpus,
                                         "memory_gb": eff.memory_gb}
        if backfill:
            self._backfills += 1
            fields.update(backfill=True, blocked_head=head,
                          head_start_bound_s=(
                              round(head_bound - now, 3)
                              if head_bound is not None else None))
        self.log.emit("admitted", **fields)
        self._start_attempt(rec, node, now, eff=eff,
                            placements=placements)

    # ------------------------------------------------------- speculation
    def _live_siblings(self, run: _Running) -> List[_Running]:
        with self._run_lock:
            return [r for r in self._running
                    if r.rec is run.rec and r is not run]

    def _maybe_speculate(self, now: float) -> None:
        sp = self.speculate
        if sp is None:
            return
        for run in list(self._running):
            if (run.speculative or run.spec_loser
                    or self._procs_running() >= self.workers):
                continue
            job = run.rec.spec
            if not getattr(job, "speculation", True):
                continue
            if max(1, job.gang) > 1:
                # no speculative duplicate gangs: two coordinators would
                # race one checkpoint dir, and a duplicate's worth of
                # slots is a whole gang's worth of capacity
                continue
            if self._spec_count.get(job.name, 0) >= sp.max_duplicates_per_job:
                continue
            if any(r.speculative for r in self._live_siblings(run)):
                continue
            alive = now - run.started_t
            if alive < sp.min_runtime_s:
                continue
            kind = self._job_kind(job)
            walls = self._kind_walls.get(kind)
            if sp.grace is not None:
                # only attempts that have outlived grace x the mean
                # completed wall of their kind are straggler suspects
                if not walls:
                    continue
                if alive <= sp.grace * (sum(walls) / len(walls)):
                    continue
            prog = self.progress_fn(run, now)
            trigger = False
            median = None
            if prog is None:
                # overdue (grace gate passed) with zero published
                # progress: the degenerate straggler
                trigger = sp.grace is not None
            else:
                peers = []
                for other in list(self._running):
                    if other is run or other.spec_loser:
                        continue
                    if self._job_kind(other.rec.spec) != kind:
                        continue
                    p = self.progress_fn(other, now)
                    if p is not None:
                        peers.append(p)
                if len(peers) < sp.min_peers:
                    peers = peers + self._kind_rates.get(kind, [])
                if len(peers) >= sp.min_peers:
                    median = statistics.median(peers)
                    trigger = median > 0 and prog < sp.slow_fraction * median
            if not trigger:
                continue
            eff = self._effective(job)
            node = self.pool.admit(eff)
            if node is None:
                continue
            self._spec_count[job.name] = \
                self._spec_count.get(job.name, 0) + 1
            self._spec_launches += 1
            self.log.emit(
                "admitted", job=job.name, node=node,
                attempt=self._attempt_seq.get(job.name, 0) + 1,
                resources={"gpus": eff.gpus, "cpus": eff.cpus,
                           "memory_gb": eff.memory_gb},
                speculative=True,
                progress_steps_per_s=(round(prog, 4)
                                      if prog is not None else None),
                median_steps_per_s=(round(median, 4)
                                    if median is not None else None))
            self._start_attempt(run.rec, node, now, eff=eff,
                                speculative=True)

    def _promote_dir(self, name: str, winner: str, orig: str) -> None:
        """Move the winning duplicate's checkpoint dir onto the declared
        path (the loser's dir is parked, never deleted — post-mortems)."""
        self._pending_promote.pop(name, None)
        error = None
        try:
            if os.path.isdir(orig):
                park = orig + ".loser"
                n = 1
                while os.path.exists(park):
                    n += 1
                    park = f"{orig}.loser{n}"
                os.rename(orig, park)
            os.rename(winner, orig)
        except OSError as exc:            # pragma: no cover - race window
            error = str(exc)
        self.log.emit("speculation_promote", job=name,
                      winner_ckpt_dir=winner, promoted_to=orig,
                      error=error)

    def _finish_promotion_if_clear(self, name: str) -> None:
        pend = self._pending_promote.get(name)
        if pend is None:
            return
        with self._run_lock:
            live = any(r.rec.spec.name == name for r in self._running)
        if not live:
            self._promote_dir(name, pend[0], pend[1])

    # ----------------------------------------------------------- finish
    def _finish_attempt(self, run: _Running, rc: int, now: float) -> None:
        rec, job = run.rec, run.rec.spec
        for fh in (run.stdout_fh, run.stderr_fh, *run.aux_fhs):
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass
        wall = now - run.started_t
        # a gang attempt holds one admission per rank — release them all
        for placement in (run.placements or [run.node]):
            self.pool.release(placement, run.eff or job.resources)
        for c in run.cores:
            self._core_load[c] -= 1
        rec.node = run.node
        self._emit_telemetry(run, final=True)
        report = None
        try:
            report = parse_trailing_report(
                run.stdout_path.read_text(errors="replace"))
        except OSError:
            pass
        hist = self._attempt_history.setdefault(job.name, [])
        self.log.emit("exited", job=job.name, attempt=run.attempt,
                      returncode=rc, wall_s=round(wall, 3),
                      speculative=run.speculative, adopted=run.adopted)
        if run.spec_loser:
            # a sibling already won this job; this exit is the planned
            # kill of the loser — account the wall, touch nothing else
            hist.append({"attempt": run.attempt,
                         "outcome": "speculation_loss",
                         "wall_s": round(wall, 3), "returncode": rc,
                         "speculative": run.speculative})
            self._spec_wall_lost += wall
            self.log.emit("speculation_loss", job=job.name,
                          attempt=run.attempt, wall_s=round(wall, 3),
                          speculative=run.speculative)
            self._finish_promotion_if_clear(job.name)
            return
        ok = (rc == 0 and report is not None
              and report.get("status") != "failed")
        if ok:
            kind = self._job_kind(job)
            tel = self._telem_summary(run)
            if tel is not None:
                self.learned.observe(
                    kind,
                    cpus=tel["cpu_pct_peak"] / 100.0,
                    memory_gb=tel["rss_peak_mb"] / 1024.0)
                rec.telemetry = tel
            m = report.get("metrics") or {}
            steps = m.get("steps") or m.get("steps_run")
            if steps and wall > 0:
                self._kind_rates.setdefault(kind, []).append(steps / wall)
            if not run.speculative:
                self._kind_walls.setdefault(kind, []).append(wall)
            # first finisher wins: gracefully stop any racing sibling
            # attempts (SIGTERM -> grace -> SIGKILL; their exits are
            # accounted as speculation losses)
            siblings = self._live_siblings(run)
            for sib in siblings:
                sib.spec_loser = True
                self._graceful_kill(sib, now, "speculation")
            entry = {"attempt": run.attempt, "outcome": "succeeded",
                     "wall_s": round(wall, 3), "returncode": rc,
                     "speculative": run.speculative}
            resumed = m.get("resumed_from_step")
            if resumed is not None:
                entry["resumed_from_step"] = int(resumed)
            hist.append(entry)
            rec.end_time = now
            rec.error = None
            rec.result = report
            rec.state = JobState.SUCCEEDED
            orig = self._checkpoint_dir(job)
            if orig and run.ckpt_dir and run.ckpt_dir != orig:
                # the duplicate won: promote its dir to the declared
                # path (deferred until the losers are reaped)
                self._spec_wins += 1
                self.log.emit("speculation_win", job=job.name,
                              attempt=run.attempt,
                              winner_ckpt_dir=run.ckpt_dir)
                self._pending_promote[job.name] = (run.ckpt_dir, orig)
                if not siblings:
                    self._finish_promotion_if_clear(job.name)
            self.log.emit("succeeded", job=job.name, attempt=run.attempt,
                          resumed_from_step=entry.get("resumed_from_step"))
            self._stage_result(rec)
            return
        # ------------------------------------------------- failure path
        timed_out = run.timed_out
        evicted = run.evicted and not timed_out
        preempted = rc < 0 and not timed_out and not evicted
        outcome = ("timeout" if timed_out
                   else "evicted" if evicted
                   else "preempted" if preempted else "failed")
        error = (report or {}).get("error") or (
            f"attempt timeout after {round(wall, 1)}s" if timed_out
            else f"evicted ({run.kill_reason})" if evicted
            else f"killed by signal {-rc}" if rc < 0
            else f"exit code {rc}")
        if run.speculative:
            # a failed duplicate never harms its job: its crash is just a
            # speculation loss — the primary is still racing
            hist.append({"attempt": run.attempt,
                         "outcome": "speculation_loss",
                         "wall_s": round(wall, 3), "returncode": rc,
                         "error": error, "speculative": True})
            self._spec_wall_lost += wall
            self.log.emit("speculation_loss", job=job.name,
                          attempt=run.attempt, wall_s=round(wall, 3),
                          speculative=True, reason=outcome)
            return
        hist.append({"attempt": run.attempt, "outcome": outcome,
                     "wall_s": round(wall, 3), "returncode": rc,
                     "error": error, "speculative": False})
        siblings = self._live_siblings(run)
        if siblings:
            # the primary died but its duplicate is alive: the duplicate
            # is the job now (no requeue — the race already restarted it)
            for sib in siblings:
                sib.speculative = False
            event = ("attempt_timeout" if timed_out
                     else "preempted" if preempted else "attempt_failed")
            self.log.emit(event, job=job.name, attempt=run.attempt,
                          error=error, requeued=False,
                          duplicate_continues=True,
                          **({"signal": -rc} if rc < 0 else {}))
            return
        if evicted:
            # evictions/drains are the scheduler's fault, not the job's:
            # the attempt is free — it consumes no retry budget
            self._free_requeues[job.name] = \
                self._free_requeues.get(job.name, 0) + 1
        retryable = (rec.attempts
                     - self._free_requeues.get(job.name, 0)) <= job.retries
        backoff_s = 0.0
        if (retryable and not preempted and not evicted
                and self.retry_backoff_base_s > 0):
            # failures and timeouts back off exponentially with full
            # jitter; signal preemptions resume immediately (the cluster
            # killed the pod — the job did nothing wrong)
            nfail = self._nfail.get(job.name, 0) + 1
            self._nfail[job.name] = nfail
            backoff_s = (min(self.retry_backoff_cap_s,
                             self.retry_backoff_base_s * 2 ** (nfail - 1))
                         * (0.5 + 0.5 * self._backoff_rng.random()))
            self._not_before[job.name] = now + backoff_s
        if timed_out:
            self.log.emit("attempt_timeout", job=job.name,
                          attempt=run.attempt, error=error,
                          requeued=retryable,
                          backoff_s=round(backoff_s, 3))
        elif evicted:
            self.log.emit("evicted", job=job.name, attempt=run.attempt,
                          reason=run.kill_reason,
                          signal=(-rc if rc < 0 else None),
                          escalated=run.escalated, requeued=retryable)
        elif preempted:
            self.log.emit("preempted", job=job.name, attempt=run.attempt,
                          signal=-rc, requeued=retryable)
        else:
            self.log.emit("attempt_failed", job=job.name,
                          attempt=run.attempt, error=error,
                          requeued=retryable,
                          backoff_s=round(backoff_s, 3))
        if retryable:
            self._queue.append(rec)
            self._queued_t[job.name] = now
            self._sort_queue()
            if evicted:
                # capacity just changed under this job — a gang that no
                # longer fits shrinks here (gang_min floor) instead of
                # waiting forever
                self._ensure_placeable(rec, now)
        else:
            rec.end_time = now
            rec.error = error
            rec.result = report
            rec.state = JobState.FAILED
            self.log.emit("failed", job=job.name, error=error)
            self._stage_result(rec)

    def _stage_result(self, rec: JobRecord) -> None:
        job = rec.spec
        hist = self._attempt_history.get(job.name, [])
        payload = {
            "job": job.name, "state": rec.state.value,
            "attempts": rec.attempts, "attempt_history": hist,
            "wall_s": (rec.end_time - rec.start_time
                       if rec.end_time and rec.start_time else None),
            "node": rec.node,
            "chaos_kills": self._chaos_kills.get(job.name, 0),
            "evictions": self._free_requeues.get(job.name, 0),
            "telemetry": rec.telemetry,
            "error": rec.error, "result": rec.result,
        }
        self.pvc.stage_json(f"results/{job.name}.json", payload)
        if self.s3 is not None and rec.state == JobState.SUCCEEDED:
            self.s3.put_bytes(f"results/{job.name}.json",
                              json.dumps({"result": rec.result},
                                         default=str).encode())

    # --------------------------------------------------------- telemetry
    def _sample_once(self) -> None:
        with self._run_lock:
            runs = list(self._running)
        mono = time.monotonic()
        for run in runs:
            pid = getattr(run.handle, "pid", None)
            if not pid:
                continue
            ticks = _read_cpu_ticks(pid)
            rss = _read_rss_mb(pid)
            io_r, io_w = _read_io_mb(pid)
            t = run.telem
            if not t:
                t.update(samples=0, cpu_pct_mean=0.0, cpu_pct_peak=0.0,
                         rss_peak_mb=0.0, io_read_mb=None,
                         io_write_mb=None)
            cpu_pct = None
            if ticks is not None:
                last = t.get("_last")
                if last is not None and mono > last[0]:
                    cpu_pct = max(0.0, (ticks - last[1]) / self._clk_tck
                                  / (mono - last[0]) * 100.0)
                t["_last"] = (mono, ticks)
            if rss is not None:
                t["rss_peak_mb"] = max(t["rss_peak_mb"], rss)
            if io_r is not None:
                t["io_read_mb"], t["io_write_mb"] = io_r, io_w
            if cpu_pct is not None:
                n = t["samples"]
                t["cpu_pct_mean"] = (t["cpu_pct_mean"] * n + cpu_pct) \
                    / (n + 1)
                t["cpu_pct_peak"] = max(t["cpu_pct_peak"], cpu_pct)
                t["samples"] = n + 1
            last_log = t.get("_last_log")
            if (t.get("samples") and
                    (last_log is None
                     or mono - last_log >= self.telemetry_log_every_s)):
                t["_last_log"] = mono
                self.log.emit("telemetry_sample", job=run.rec.spec.name,
                              attempt=run.attempt,
                              cpu_pct=round(cpu_pct, 1)
                              if cpu_pct is not None else None,
                              rss_mb=round(rss, 1)
                              if rss is not None else None,
                              io_read_mb=io_r, io_write_mb=io_w)

    def _sampler_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._sample_once()
            except Exception:            # never let telemetry kill a run
                pass
            self._stop.wait(self.telemetry_every_s)

    def _telem_summary(self, run: _Running) -> Optional[Dict[str, Any]]:
        t = run.telem
        if not t or not t.get("samples"):
            return None
        return {"samples": t["samples"],
                "cpu_pct_mean": round(t["cpu_pct_mean"], 2),
                "cpu_pct_peak": round(t["cpu_pct_peak"], 2),
                "rss_peak_mb": round(t["rss_peak_mb"], 2),
                "io_read_mb": t["io_read_mb"],
                "io_write_mb": t["io_write_mb"]}

    def _emit_telemetry(self, run: _Running, final: bool = False) -> None:
        summary = self._telem_summary(run)
        if summary is not None:
            self.log.emit("telemetry", job=run.rec.spec.name,
                          attempt=run.attempt, final=final,
                          summary=summary)

    # ---------------------------------------------------------- backfill
    def _head_earliest_start(self, head_eff: Resources,
                             now: float) -> Optional[float]:
        """Earliest time the blocked queue head could start, simulating
        the release of every running attempt at its estimated finish
        (mean observed wall of its kind).  None when any running attempt
        has no estimate — conservative: no EASY backfill then."""
        free = {n.name: [n.gpus_free, n.cpus_free, n.mem_free,
                         n.spec.gpu_memory_gb]
                for n in self.pool.nodes}

        def fits_any() -> bool:
            return any(head_eff.fits(g, c, m, v)
                       for g, c, m, v in free.values())

        if fits_any():
            return now
        ends = []
        with self._run_lock:
            running = list(self._running)
        for run in running:
            est = self._est_wall(self._job_kind(run.rec.spec))
            if est is None:
                return None
            ends.append((max(now, run.started_t + est), run))
        for t_end, run in sorted(ends, key=lambda x: x[0]):
            res = run.eff or run.rec.spec.resources
            slot = free[run.node]
            slot[0] += res.gpus
            slot[1] += res.cpus
            slot[2] += res.memory_gb
            if fits_any():
                return t_end
        return None

    # ---------------------------------------------------------- resume
    def _apply_resume(self, now: float) -> bool:
        """Replay the existing event log and fold it into this run:
        completed jobs stay completed, live orphans are adopted, dead
        orphans re-queue on the resume path."""
        path = self.pvc.path(EVENTS_REL)
        try:
            lines = path.read_text(encoding="utf-8").splitlines()
        except OSError:
            return False
        state = replay_events(lines)
        if not state["jobs"]:
            return False
        for name, st in state["jobs"].items():
            rec = self.records.get(name)
            if rec is None:
                continue
            kind_key = self._job_kind(rec.spec)
            self._attempt_seq[name] = max(
                [st["attempts"]]
                + [int(a) for a in st["live"].keys() or [0]])
            if st["state"] in ("Succeeded", "Failed"):
                # any orphan attempt of a completed job (e.g. a
                # speculation loser the dead scheduler never reaped) is
                # stale by definition: kill it rather than adopt it
                for att, info in sorted(st["live"].items()):
                    pid = info.get("pid")
                    if pid and _pid_alive(pid, info.get("pid_start")):
                        try:
                            os.kill(pid, int(_signal.SIGKILL))
                        except OSError:
                            pass
                    self.log.emit("orphan_killed", job=name,
                                  attempt=int(att), pid=pid)
            if st["state"] == "Succeeded":
                self._resumed_done += 1
                if rec in self._queue:
                    self._queue.remove(rec)
                rec.state = JobState.SUCCEEDED
                rec.attempts = st["attempts"]
                rec.node = st["node"]
                rec.telemetry = st["telemetry"]
                res_p = self.pvc.path(f"results/{name}.json")
                if res_p.exists():
                    try:
                        payload = json.loads(res_p.read_text())
                        rec.result = payload.get("result")
                        if payload.get("attempt_history"):
                            self._attempt_history[name] = \
                                payload["attempt_history"]
                    except (OSError, ValueError):
                        pass
                if st["succeeded_wall_s"]:
                    self._kind_walls.setdefault(kind_key, []).append(
                        float(st["succeeded_wall_s"]))
                tel = st["telemetry"]
                if tel and tel.get("samples"):
                    self.learned.observe(
                        kind_key,
                        cpus=(tel.get("cpu_pct_peak") or 0.0) / 100.0,
                        memory_gb=(tel.get("rss_peak_mb") or 0.0)
                        / 1024.0)
                # a win recorded but no promote: the scheduler died
                # between the win and the rename — finish the promotion
                if st["winner_ckpt_dir"] and not st["promoted"]:
                    orig = self._checkpoint_dir(rec.spec)
                    if orig and os.path.isdir(st["winner_ckpt_dir"]):
                        self._promote_dir(name, st["winner_ckpt_dir"],
                                          orig)
                continue
            if st["state"] == "Failed":
                self._resumed_done += 1
                if rec in self._queue:
                    self._queue.remove(rec)
                rec.state = JobState.FAILED
                rec.attempts = st["attempts"]
                rec.error = st["error"]
                continue
            # pending or running at crash time
            rec.attempts = st["attempts"]
            adopted_any = False
            for att, info in sorted(st["live"].items()):
                pid = info.get("pid")
                pid_start = info.get("pid_start")
                ranks = info.get("ranks")
                if ranks:
                    # a dead scheduler's gang is never adopted: its
                    # coordinator address and rank membership can't be
                    # reconstructed safely — kill every surviving rank
                    # and requeue the whole gang on the resume path
                    for rk in ranks:
                        rpid = rk.get("pid")
                        if rpid and _pid_alive(rpid, rk.get("pid_start")):
                            try:
                                os.kill(rpid, int(_signal.SIGKILL))
                            except OSError:
                                pass
                    self._orphans_requeued += 1
                    self.log.emit("orphan_requeued", job=name,
                                  attempt=int(att), pid=pid,
                                  gang=len(ranks))
                    continue
                if pid and _pid_alive(pid, pid_start):
                    eff = rec.spec.resources     # declared: safe bound
                    # pin to the node the attempt already runs on; a
                    # free pick could swap two orphans' nodes and leave
                    # the log claiming placements that never happened
                    node = self.pool.admit(eff, prefer=st["node"])
                    if node is None:
                        # inventory shrank under us: kill, fall through
                        # to the requeue path
                        try:
                            os.kill(pid, int(_signal.SIGKILL))
                        except OSError:
                            pass
                    else:
                        out_p = self.pvc.path(
                            f"logs/{name}.attempt{att}.out")
                        err_p = self.pvc.path(
                            f"logs/{name}.attempt{att}.err")
                        handle = _AdoptedHandle(pid, pid_start, out_p)
                        run = _Running(
                            rec=rec, attempt=int(att), node=node,
                            handle=handle, stdout_path=out_p,
                            stderr_path=err_p, stdout_fh=None,
                            stderr_fh=None,
                            started_t=float(info.get("t") or now),
                            resume=False, eff=eff,
                            speculative=bool(info.get("speculative")),
                            adopted=True,
                            ckpt_dir=info.get("ckpt_dir"))
                        with self._run_lock:
                            self._running.append(run)
                        rec.state = JobState.RUNNING
                        if rec.start_time is None:
                            rec.start_time = float(info.get("t") or now)
                        self._adopted += 1
                        adopted_any = True
                        self.log.emit("adopted", job=name,
                                      attempt=int(att), pid=pid,
                                      pid_start=pid_start, node=node,
                                      resources={
                                          "gpus": eff.gpus,
                                          "cpus": eff.cpus,
                                          "memory_gb": eff.memory_gb},
                                      ckpt_dir=info.get("ckpt_dir"))
                        continue
                self._orphans_requeued += 1
                self.log.emit("orphan_requeued", job=name,
                              attempt=int(att), pid=pid)
            if adopted_any and rec in self._queue:
                self._queue.remove(rec)
        return True

    # ---------------------------------------------------------------- run
    def run(self) -> Dict[str, JobRecord]:
        t0 = self.clock()
        self._sort_queue()
        resumed = self.resume and self._apply_resume(t0)
        if resumed:
            # campaign_resume continues the replayed campaign — a fresh
            # campaign_start would make replay discard its own history
            with self._run_lock:
                live_allocs = [
                    {"job": r.rec.spec.name, "attempt": r.attempt,
                     "placements": list(r.placements or [r.node]),
                     "resources": {
                         "gpus": (r.eff or r.rec.spec.resources).gpus,
                         "cpus": (r.eff or r.rec.spec.resources).cpus,
                         "memory_gb":
                             (r.eff or r.rec.spec.resources).memory_gb}}
                    for r in self._running]
            self.log.emit("campaign_resume", workers=self.workers,
                          jobs=len(self._queue) + len(self._running),
                          done=self._resumed_done,
                          adopted=self._adopted,
                          requeued=self._orphans_requeued,
                          nodes=len(self.pool.nodes),
                          inventory=self.pool.snapshot(),
                          live_allocs=live_allocs)
        else:
            self.log.emit("campaign_start", workers=self.workers,
                          jobs=len(self._queue),
                          nodes=len(self.pool.nodes),
                          placement=self.pool.policy.name,
                          inventory=self.pool.snapshot())
        # fail jobs that could never be placed, before anything runs
        # (a gang needs `gang` process slots at once: more ranks than
        # workers would block the queue head forever even on an
        # infinite inventory — unless gang_min lets it shrink)
        for rec in list(self._queue):
            self._ensure_placeable(rec, t0, initial=True)
        for rec in self._queue:
            self._queued_t[rec.spec.name] = t0
            self.log.emit("submitted", job=rec.spec.name,
                          priority=rec.spec.priority,
                          kind=rec.spec.env.get("RUN_KIND"),
                          gang=max(1, rec.spec.gang),
                          resources={
                              "gpus": rec.spec.resources.gpus,
                              "cpus": rec.spec.resources.cpus,
                              "memory_gb": rec.spec.resources.memory_gb})
        if self.telemetry:
            self._sampler = threading.Thread(target=self._sampler_loop,
                                             name="telemetry-sampler",
                                             daemon=True)
            self._sampler.start()
        try:
            self._loop()
        finally:
            self._stop.set()
            if self._sampler is not None:
                self._sampler.join(timeout=5.0)
        makespan = self.clock() - t0
        self._write_summary(makespan)
        self.log.emit("campaign_end", makespan_s=round(makespan, 3),
                      **{k: self.summary[k]
                         for k in ("jobs", "states", "preemptions",
                                   "wall_goodput")})
        self.log.close()
        return self.records

    def _loop(self) -> None:
        while self._queue or self._running:
            now = self.clock()
            # ---- elastic inventory: apply nodes.json rewrites, reap
            # drained-empty nodes, and let high-priority heads evict
            self._check_nodes_file(now)
            self._reap_drained()
            self._maybe_evict(now)
            # ---- admission: strict head-of-line within (-priority,
            # order) among backoff-eligible jobs; optional backfill past
            # a blocked head under the no-head-delay bound.  The worker
            # cap counts *processes*: a gang of N consumes N slots.
            progressed = True
            while progressed and self._procs_running() < self.workers:
                progressed = False
                eligible = [r for r in self._queue
                            if self._not_before.get(r.spec.name, 0.0)
                            <= now]
                if not eligible:
                    break
                head = eligible[0]
                head_gang = self._gang(head.spec)
                head_eff = self._effective(head.spec)
                if self._procs_running() + head_gang > self.workers:
                    # head blocked on process slots, not nodes: no
                    # backfill (a backfiller would hold the very slot
                    # the head is waiting for)
                    break
                if head_gang > 1:
                    placements = self.pool.admit_gang(head_eff, head_gang)
                    if placements is not None:
                        self._admit(head, placements[0], now,
                                    eff=head_eff, placements=placements)
                        progressed = True
                        continue
                else:
                    node = self.pool.admit(head_eff)
                    if node is not None:
                        self._admit(head, node, now, eff=head_eff)
                        progressed = True
                        continue
                if not self.backfill:
                    break
                # EASY reasoning models single-node release order; for a
                # gang head only the provably-disjoint rule is sound
                t_head = (None if head_gang > 1
                          else self._head_earliest_start(head_eff, now))
                for cand in eligible[1:]:
                    if cand.spec.gang > 1:
                        # gangs never backfill: an N-slot jump past a
                        # blocked head is exactly the starvation the
                        # bound exists to prevent
                        continue
                    if self._procs_running() >= self.workers:
                        break
                    eff_c = self._effective(cand.spec)
                    target = self.pool.peek_node(eff_c)
                    if target is None:
                        continue
                    # sound rule: the head could never use the
                    # candidate's target node, even empty
                    disjoint = not head_eff.fits(
                        target.spec.gpus, target.spec.cpus,
                        target.spec.memory_gb, target.spec.gpu_memory_gb)
                    est_c = self._est_wall(self._job_kind(cand.spec))
                    # EASY rule: the candidate's estimated finish lands
                    # before the head's earliest feasible start
                    easy_ok = (t_head is not None and est_c is not None
                               and now + est_c <= t_head)
                    if not (disjoint or easy_ok):
                        continue
                    node = self.pool.admit(eff_c)
                    if node is None:
                        continue
                    self._admit(cand, node, now, eff=eff_c,
                                backfill=True, head=head.spec.name,
                                head_bound=t_head)
                    progressed = True
                    break
            # ---- speculative duplicates into leftover capacity
            self._maybe_speculate(now)
            # ---- poll running attempts
            for run in list(self._running):
                rc = run.handle.poll()
                if rc is None:
                    # SIGTERM'd attempts that outlive the grace window
                    # are escalated to SIGKILL (pod-preemption contract)
                    self._escalate_overdue(run, now)
                    alive = now - run.started_t
                    name = run.rec.spec.name
                    kills = self._chaos_kills.get(name, 0)
                    # cheap membership/budget checks first; the
                    # checkpoint-dir scan (disk) only runs for live
                    # victims that still have kills left.  Speculative
                    # duplicates are not chaos victims.
                    victim = (self.chaos is not None
                              and not run.speculative
                              and not run.spec_loser
                              and name in self.chaos.kill_jobs
                              and kills < self.chaos.max_kills_per_job)
                    if victim and self.chaos.wants_kill(
                            name, kills, alive,
                            _published_checkpoints(
                                self._checkpoint_dir(run.rec.spec))):
                        self._chaos_kills[name] = kills + 1
                        if run.gang > 1:
                            # kill ONE rank (the last, not the
                            # coordinator) — the point of gang chaos is
                            # proving any member's death condemns and
                            # requeues the whole gang
                            victim_rank = run.gang - 1
                            self.log.emit("chaos_kill", job=name,
                                          attempt=run.attempt,
                                          signal=self.chaos.signal,
                                          rank=victim_rank)
                            run.handle.signal_rank(victim_rank,
                                                   self.chaos.signal)
                        else:
                            self.log.emit("chaos_kill", job=name,
                                          attempt=run.attempt,
                                          signal=self.chaos.signal)
                            run.handle.send_signal(self.chaos.signal)
                        if self.chaos.signal == int(_signal.SIGTERM):
                            # graceful chaos rides the same escalation
                            # clock as evictions
                            run.term_t = run.term_t or now
                            run.kill_reason = run.kill_reason or "chaos"
                    elif (self.attempt_timeout_s is not None
                            and alive > self.attempt_timeout_s
                            and not run.timed_out and not run.spec_loser):
                        run.timed_out = True
                        self.log.emit("timeout_kill", job=name,
                                      attempt=run.attempt,
                                      after_s=round(alive, 1))
                        run.handle.send_signal(int(_signal.SIGKILL))
                    continue
                with self._run_lock:
                    self._running.remove(run)
                self._finish_attempt(run, rc, now)
            if self._running:
                time.sleep(self.poll_s)
            elif self._queue:
                # nothing running and the whole queue is backing off:
                # idle-wait instead of hot-spinning on the clock
                time.sleep(self.poll_s)

    # ------------------------------------------------------------ summary
    def _write_summary(self, makespan: float) -> None:
        hists = self._attempt_history
        all_attempts = [a for h in hists.values() for a in h]
        useful = sum(a["wall_s"] for a in all_attempts
                     if a["outcome"] == "succeeded")
        lost = sum(a["wall_s"] for a in all_attempts
                   if a["outcome"] != "succeeded")
        salvaged = sum(a.get("resumed_from_step") or 0
                       for a in all_attempts if a["outcome"] == "succeeded")
        states: Dict[str, int] = {}
        for r in self.records.values():
            states[r.state.value] = states.get(r.state.value, 0) + 1
        waits = sorted(self.queue_waits)

        def pct(p: float) -> float:
            if not waits:
                return 0.0
            i = min(len(waits) - 1, int(round(p / 100 * (len(waits) - 1))))
            return round(waits[i], 4)

        n_preempted = sum(1 for a in all_attempts
                          if a["outcome"] == "preempted")
        n_timeout = sum(1 for a in all_attempts
                        if a["outcome"] == "timeout")
        n_evicted = sum(1 for a in all_attempts
                        if a["outcome"] == "evicted")
        n_spec_loss = sum(1 for a in all_attempts
                          if a["outcome"] == "speculation_loss")
        self.summary = {
            "workers": self.workers,
            "jobs": len(self.records),
            "states": states,
            "makespan_s": round(makespan, 3),
            "serial_attempt_wall_s": round(useful + lost, 3),
            "queue_wait_s": {"p50": pct(50), "p95": pct(95),
                             "max": pct(100),
                             "mean": round(sum(waits) / len(waits), 4)
                             if waits else 0.0},
            "attempts_total": len(all_attempts),
            # a timed-out or evicted attempt is lost work exactly like a
            # preempted one; all count here (each also reported alone)
            "preemptions": n_preempted + n_timeout + n_evicted,
            "timeouts": n_timeout,
            "evictions": n_evicted,
            "evict_signals": self._evict_signals,
            "chaos_kills": sum(self._chaos_kills.values()),
            "useful_attempt_wall_s": round(useful, 3),
            "lost_attempt_wall_s": round(lost, 3),
            "wall_goodput": round(useful / (useful + lost), 4)
            if useful + lost > 0 else 1.0,
            "steps_salvaged_by_resume": int(salvaged),
            "speedup_vs_serial": round((useful + lost) / makespan, 3)
            if makespan > 0 else 0.0,
            "speculation": {"launches": self._spec_launches,
                            "wins": self._spec_wins,
                            "losses": n_spec_loss,
                            "loss_wall_s": round(self._spec_wall_lost,
                                                 3)},
            "backfills": self._backfills,
            "resumed": bool(self._resumed_done or self._adopted
                            or self._orphans_requeued),
            "resumed_done": self._resumed_done,
            "orphans_adopted": self._adopted,
            "orphans_requeued": self._orphans_requeued,
            "learned_requests": self.learned.snapshot(),
            "nodes": {"added": self._nodes_added,
                      "drained": self._nodes_drained,
                      "removed": self._nodes_removed,
                      "final": self.pool.snapshot()},
            "placement": self.pool.policy.name,
            # the utilization ledger is derived SOLELY from event-log
            # replay (not from in-memory counters), so `campaign status
            # --json` over the same log reproduces it bit-for-bit
            "utilization": self._replay_utilization(),
        }
        self.pvc.stage_json("results/_campaign_summary.json", self.summary)

    def _replay_utilization(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.log.path, "r", encoding="utf-8") as fh:
                return replay_events(fh).get("utilization")
        except OSError:
            return None


# --------------------------------------------------------------------------
# Status view
# --------------------------------------------------------------------------
def find_events_file(path) -> Optional[Path]:
    """Resolve a ``campaign status`` target: an events file, or a
    directory searched (newest-first) for ``events.jsonl``."""
    p = Path(path)
    if p.is_file():
        return p
    if p.is_dir():
        cands = sorted(p.rglob("events.jsonl"),
                       key=lambda q: q.stat().st_mtime, reverse=True)
        if cands:
            return cands[0]
    return None


def format_status(state: Dict[str, Any]) -> str:
    """Human-readable table for ``python -m repro_torch.launch campaign
    status`` from a :func:`replay_events` result."""
    lines = []
    jobs = state["jobs"]
    width = max([len(n) for n in jobs] + [4])

    def gang_cell(st: Dict[str, Any]) -> str:
        # a gang job is ONE row; this cell carries the per-rank view of
        # its newest attempt: "run" while alive, the exit code once dead
        if int(st.get("gang") or 1) <= 1:
            return "-"
        ranks = st.get("ranks") or {}
        parts = []
        for rk in sorted(ranks, key=int):
            rc = ranks[rk].get("returncode")
            parts.append(f"{rk}:{'run' if rc is None else rc}")
        return f"{st['gang']}[{' '.join(parts)}]" if parts \
            else str(st["gang"])

    lines.append(f"{'job':<{width}}  {'state':<10} {'attempts':>8} "
                 f"{'preempt':>7} {'evict':>5} {'resumed@':>8} "
                 f"{'rss_mb':>7} "
                 f"{'cpu%':>6} {'obs/req':>7}  {'gang':<14} node")
    for name in sorted(jobs):
        st = jobs[name]
        resumed = st["resumed_from_step"]
        tel = st.get("telemetry") or {}
        ratio = st.get("declared_vs_observed") or {}
        rss = tel.get("rss_peak_mb")
        cpu = tel.get("cpu_pct_mean")
        obs = ratio.get("cpus")
        gcell = gang_cell(st)
        if st.get("gang_shrunk_from"):
            inner = gcell if gcell != "-" else str(st.get("gang") or 1)
            gcell = f"{st['gang_shrunk_from']}->{inner}"
        lines.append(
            f"{name:<{width}}  {st['state']:<10} {st['attempts']:>8} "
            f"{st['preemptions']:>7} "
            f"{st.get('evictions') or 0:>5} "
            f"{('-' if resumed is None else resumed):>8} "
            f"{('-' if rss is None else round(rss)):>7} "
            f"{('-' if cpu is None else round(cpu)):>6} "
            f"{('-' if obs is None else obs):>7}  "
            f"{gcell:<14} "
            f"{st['node'] or '-'}")
    tail = (f"{len(jobs)} jobs {state['counts']} workers={state['workers']} "
            f"ended={state['ended']}")
    nodes = state.get("nodes") or {}
    if nodes:
        draining = sum(1 for n in nodes.values() if n.get("draining"))
        tail += f" nodes={len(nodes)}"
        if draining:
            tail += f"({draining} draining)"
    if state["makespan_s"] is not None:
        tail += f" makespan_s={state['makespan_s']}"
    if state.get("resumes"):
        tail += f" resumes={state['resumes']}"
    util = (state.get("utilization") or {}).get("cluster")
    if util:
        tail += (f" gpu_util={util['busy_gpu_util']}"
                 f"(goodput {util['goodput_gpu_util']})")
    if not state["consistent"]:
        tail += f"  INCONSISTENT: {state['violations']}"
    lines.append(tail)
    return "\n".join(lines)

"""Heterogeneous-cluster discrete-event scheduler simulation (the port's
copy of ``repro.core.scheduler``).

The paper's value proposition is cluster-level: 234 models / 4,040 hours of
compute run *in parallel* on Nautilus ("over five and a half months if this
compute were to be performed on a single server").  :class:`ClusterSim`
reproduces that accounting: given a node inventory (modeled on Nautilus's
heterogeneous GPU fleet, GTX-1080 11 GB through A100 80 GB) and a set of
jobs with resource requests and durations, it simulates placement,
queueing, optional preemption, and reports makespan and utilization —
deterministically.

The same JobSpecs can be scheduled against any other inventory (a list of
:class:`NodeSpec`) to size a campaign before submitting it.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.jobs import JobRecord, JobSpec, JobState, Resources


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    name: str
    gpus: int
    gpu_memory_gb: float
    cpus: int
    memory_gb: float
    count: int = 1

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def node_spec_from_dict(d: Dict[str, object]) -> NodeSpec:
    """A single inventory entry from its JSON form (``to_dict`` inverse;
    missing optionals default)."""
    return NodeSpec(
        name=str(d["name"]),
        gpus=int(d.get("gpus", 0)),
        gpu_memory_gb=float(d.get("gpu_memory_gb", 0.0)),
        cpus=int(d.get("cpus", 1)),
        memory_gb=float(d.get("memory_gb", 1.0)),
        count=int(d.get("count", 1)))


def node_specs_from_json(obj: object) -> List[NodeSpec]:
    """Parse the ``campaign/nodes.json`` control-file payload: either a
    bare list of node dicts or ``{"nodes": [...]}``.  Raises on any
    malformed entry so a torn write is rejected whole."""
    if isinstance(obj, dict):
        obj = obj.get("nodes")
    if not isinstance(obj, list):
        raise ValueError("nodes.json must be a list or {'nodes': [...]}")
    specs = [node_spec_from_dict(d) for d in obj]
    if len({s.name for s in specs}) != len(specs):
        raise ValueError("duplicate node names in nodes.json")
    return specs


# Modeled on the paper's description of Nautilus: "over 1300 NVIDIA GPUs and
# 19,000 CPU Cores", "GPUs on Nautilus range from as little as the NVIDIA
# GTX 1080 (11 GB) to as high as the NVIDIA A100 (80GB)".
NAUTILUS_INVENTORY: List[NodeSpec] = [
    NodeSpec("gtx1080-8g", gpus=8, gpu_memory_gb=11, cpus=64, memory_gb=256, count=45),
    NodeSpec("rtx2080ti-8g", gpus=8, gpu_memory_gb=11, cpus=64, memory_gb=256, count=30),
    NodeSpec("rtx3090-8g", gpus=8, gpu_memory_gb=24, cpus=96, memory_gb=384, count=45),
    NodeSpec("a40-4g", gpus=4, gpu_memory_gb=48, cpus=96, memory_gb=512, count=30),
    NodeSpec("v100-8g", gpus=8, gpu_memory_gb=32, cpus=96, memory_gb=384, count=15),
    NodeSpec("a100-8g", gpus=8, gpu_memory_gb=80, cpus=128, memory_gb=1024, count=12),
    NodeSpec("cpu-pool", gpus=0, gpu_memory_gb=0, cpus=96, memory_gb=512, count=40),
]
# totals: 1,296 GPUs and ~18.8k CPU cores — matching the paper's "over
# 1300 NVIDIA GPUs and 19,000 CPU Cores" era within rounding.


class LearnedRequests:
    """Observed-usage admission model: declared resource requests are
    habitually padded (the gap "Benchmarking Resource Usage" measures on
    real clusters), so the executor records each completed attempt's
    peak CPU cores and RSS per job *kind* and, once ``min_samples``
    attempts of a kind have completed, admits later jobs of that kind at
    the p95 of observed peaks instead of the declared number.

    The declared request stays a hard **ceiling** (a job never gets
    admitted with more than it asked for) and there are floors of one
    core / ``mem_floor_gb``, so the effective request always satisfies
    ``floor <= effective <= declared`` — tightening requests can only
    *increase* packing, never oversubscribe a node.  GPUs are never
    learned: a device is held exclusively whether busy or not.
    """

    def __init__(self, min_samples: int = 3, percentile: float = 95.0,
                 mem_floor_gb: float = 0.25):
        self.min_samples = int(min_samples)
        self.percentile = float(percentile)
        self.mem_floor_gb = float(mem_floor_gb)
        self._cpu: Dict[str, List[float]] = {}
        self._mem: Dict[str, List[float]] = {}

    def observe(self, kind: str, *, cpus: Optional[float] = None,
                memory_gb: Optional[float] = None) -> None:
        """Record one completed attempt's peak usage (cores, GB)."""
        if cpus is not None:
            self._cpu.setdefault(kind, []).append(float(cpus))
        if memory_gb is not None:
            self._mem.setdefault(kind, []).append(float(memory_gb))

    def _pct(self, vals: List[float]) -> float:
        vs = sorted(vals)
        i = min(len(vs) - 1,
                max(0, math.ceil(self.percentile / 100.0 * len(vs)) - 1))
        return vs[i]

    def effective(self, kind: str, declared: Resources) -> Resources:
        """The request to admit with: observed p95 clamped into
        ``[floor, declared]``; the declared request verbatim until
        ``min_samples`` observations of this kind exist."""
        cpu_s = self._cpu.get(kind, ())
        mem_s = self._mem.get(kind, ())
        cpus = declared.cpus
        mem = declared.memory_gb
        if len(cpu_s) >= self.min_samples:
            cpus = min(declared.cpus,
                       max(1, math.ceil(self._pct(list(cpu_s)))))
        if len(mem_s) >= self.min_samples:
            mem = min(declared.memory_gb,
                      max(self.mem_floor_gb,
                          round(self._pct(list(mem_s)), 3)))
        if cpus == declared.cpus and mem == declared.memory_gb:
            return declared
        return dataclasses.replace(declared, cpus=cpus, memory_gb=mem)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-kind learned state for summaries / ``campaign status``."""
        out: Dict[str, Dict[str, float]] = {}
        for kind in sorted(set(self._cpu) | set(self._mem)):
            entry: Dict[str, float] = {}
            cpu_s, mem_s = self._cpu.get(kind), self._mem.get(kind)
            if cpu_s:
                entry["cpu_samples"] = len(cpu_s)
                entry["cpu_p95_cores"] = round(self._pct(cpu_s), 3)
            if mem_s:
                entry["mem_samples"] = len(mem_s)
                entry["mem_p95_gb"] = round(self._pct(mem_s), 3)
            out[kind] = entry
        return out


@dataclasses.dataclass
class _Node:
    spec: NodeSpec
    name: str
    gpus_free: int = 0
    cpus_free: int = 0
    mem_free: float = 0.0

    def __post_init__(self):
        self.gpus_free = self.spec.gpus
        self.cpus_free = self.spec.cpus
        self.mem_free = self.spec.memory_gb


@dataclasses.dataclass
class SimResult:
    makespan_h: float
    total_gpu_hours: float
    total_wall_hours: float          # sum of per-job wall time
    records: List[JobRecord]
    gpu_utilization: float
    queue_wait_h_mean: float
    per_node_busy_h: Dict[str, float]
    # preemption accounting (checkpoint-aware): work redone because it
    # wasn't checkpointed, and the fraction of occupancy that was useful
    preemptions: int = 0
    lost_gpu_hours: float = 0.0
    goodput: float = 1.0
    # busy vs goodput, aligned with the executor's utilization ledger:
    # busy counts every occupied GPU-hour (useful or lost), goodput only
    # the hours that survived preemption — per node they reconcile as
    # sum(busy) == total_gpu_hours + lost_gpu_hours and
    # sum(goodput) == total_gpu_hours; ``gpu_utilization`` stays the
    # goodput flavor for backwards compatibility.
    per_node_goodput_h: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    busy_utilization: float = 0.0
    goodput_utilization: float = 0.0

    def speedup_vs_serial(self) -> float:
        return self.total_wall_hours / self.makespan_h if self.makespan_h else 0.0


class ClusterSim:
    """Deterministic discrete-event job scheduler.

    ``checkpoint_every_h > 0`` models jobs that checkpoint durably on
    that cadence: a preemption then loses only the work since the last
    checkpoint (the resubmitted job runs ``duration - retained`` hours)
    instead of the whole attempt — the difference between the paper's
    restart-from-scratch regime and this PR's resume subsystem.
    """

    def __init__(self, inventory: Sequence[NodeSpec] = None, seed: int = 0,
                 preemption_rate: float = 0.0,
                 checkpoint_every_h: float = 0.0,
                 placement=None):
        from repro_torch.core.placement import get_placement_policy
        inventory = inventory if inventory is not None else NAUTILUS_INVENTORY
        self.nodes: List[_Node] = []
        for spec in inventory:
            for i in range(spec.count):
                self.nodes.append(_Node(spec, f"{spec.name}-{i:03d}"))
        self.rng = random.Random(seed)
        self.preemption_rate = preemption_rate
        self.checkpoint_every_h = checkpoint_every_h
        # same PlacementPolicy names as the real executor pool, so a
        # policy evaluated here is the policy `campaign run --placement`
        # executes (default best_fit = the historical hard-coded sort)
        self.placement = get_placement_policy(placement)

    def _find_node(self, spec: JobSpec) -> Optional[_Node]:
        cands = [n for n in self.nodes
                 if spec.resources.fits(n.gpus_free, n.cpus_free, n.mem_free,
                                        n.spec.gpu_memory_gb)]
        if not cands:
            return None
        return self.placement.order(cands, spec.resources)[0]

    def run(self, jobs: Sequence[JobSpec]) -> SimResult:
        records = [JobRecord(spec=j) for j in jobs]
        pending: List[Tuple[float, int]] = [(0.0, i) for i in range(len(records))]
        # event heap: (time, seq, kind, payload)
        events: List[Tuple[float, int, str, tuple]] = []
        seq = 0
        now = 0.0
        busy: Dict[str, float] = {n.name: 0.0 for n in self.nodes}
        good: Dict[str, float] = {n.name: 0.0 for n in self.nodes}
        queue_waits: List[float] = []
        ckpt = self.checkpoint_every_h
        # per-job retained progress (always a multiple of ckpt; stays 0
        # without checkpointing -> every retry recomputes from scratch)
        done = [0.0] * len(records)
        preemptions = 0
        lost_h = 0.0

        def try_schedule():
            nonlocal seq, preemptions, lost_h
            still = []
            # FIFO within priority, mirroring the real executor's
            # admission order (highest priority first, then submit
            # time, then submission index as the deterministic tie)
            for submit_t, idx in sorted(
                    pending,
                    key=lambda p: (-records[p[1]].spec.priority, p[0], p[1])):
                rec = records[idx]
                node = self._find_node(rec.spec)
                if node is None:
                    still.append((submit_t, idx))
                    continue
                node.gpus_free -= rec.spec.resources.gpus
                node.cpus_free -= rec.spec.resources.cpus
                node.mem_free -= rec.spec.resources.memory_gb
                rec.state = JobState.RUNNING
                rec.node = node.name
                rec.start_time = now
                rec.attempts += 1
                queue_waits.append(now - submit_t)
                gpus = rec.spec.resources.gpus
                work = rec.spec.duration_h - done[idx]   # remaining work
                preempt = (self.preemption_rate > 0
                           and rec.attempts <= rec.spec.retries
                           and self.rng.random() < self.preemption_rate)
                if preempt:
                    dur = work * self.rng.uniform(0.1, 0.9)
                    preemptions += 1
                    if ckpt > 0:      # resume keeps whole checkpoints
                        total = done[idx] + dur
                        retained = (total // ckpt) * ckpt
                        lost_h += (total - retained) * gpus
                        # checkpoints newly banked this attempt survive
                        good[node.name] += (retained - done[idx]) * gpus
                        done[idx] = retained
                    else:             # restart-from-scratch regime
                        lost_h += dur * gpus
                    heapq.heappush(events, (now + dur, seq, "preempt", (idx,)))
                else:
                    dur = work
                    good[node.name] += dur * gpus
                    heapq.heappush(events, (now + dur, seq, "finish", (idx,)))
                seq += 1
                busy[node.name] += dur * gpus
            pending[:] = still

        try_schedule()
        while events:
            now, _, kind, (idx,) = heapq.heappop(events)
            rec = records[idx]
            node = next(n for n in self.nodes if n.name == rec.node)
            node.gpus_free += rec.spec.resources.gpus
            node.cpus_free += rec.spec.resources.cpus
            node.mem_free += rec.spec.resources.memory_gb
            if kind == "finish":
                rec.state = JobState.SUCCEEDED
                rec.end_time = now
            else:  # preempted: resubmit (Nautilus opportunistic semantics)
                rec.state = JobState.PREEMPTED
                pending.append((now, idx))
            try_schedule()

        total_gpu_h = sum(r.spec.duration_h * r.spec.resources.gpus
                          for r in records)
        total_wall = sum(r.spec.duration_h for r in records)
        # availability denominator; guard CPU-only inventories too
        avail = now * sum(n.spec.gpus for n in self.nodes)
        util_good = total_gpu_h / avail if avail > 0 else 0.0
        util_busy = sum(busy.values()) / avail if avail > 0 else 0.0
        return SimResult(
            makespan_h=now,
            total_gpu_hours=total_gpu_h,
            total_wall_hours=total_wall,
            records=records,
            gpu_utilization=util_good,
            queue_wait_h_mean=(sum(queue_waits) / len(queue_waits)
                               if queue_waits else 0.0),
            per_node_busy_h=busy,
            preemptions=preemptions,
            lost_gpu_hours=lost_h,
            goodput=(total_gpu_h / (total_gpu_h + lost_h)
                     if total_gpu_h + lost_h > 0 else 1.0),
            per_node_goodput_h=good,
            busy_utilization=util_busy,
            goodput_utilization=util_good,
        )

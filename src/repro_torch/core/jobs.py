"""Declarative jobs — the Kubernetes-Job analogue (the port's copy of
``repro.core.jobs``).

A :class:`JobSpec` is a fully reproducible unit of work: a named payload,
explicit resource requests (the paper allocates e.g. "24GB of memory, four
CPUs, and two GPUs for each model"), environment variables (the paper's
bash automation passes the model/dataset selection via env), retry policy
(Nautilus preempts opportunistic jobs), and labels for bookkeeping.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class Resources:
    gpus: int = 1
    cpus: int = 4
    memory_gb: float = 24.0
    gpu_memory_gb_min: float = 0.0   # schedule only on nodes with >= this VRAM

    def fits(self, gpus_free: int, cpus_free: int, mem_free: float,
             gpu_memory_gb: float) -> bool:
        return (gpus_free >= self.gpus and cpus_free >= self.cpus
                and mem_free >= self.memory_gb
                and gpu_memory_gb >= self.gpu_memory_gb_min)


class JobState(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    PREEMPTED = "Preempted"


@dataclasses.dataclass
class JobSpec:
    name: str
    payload: Optional[Callable[..., Any]] = None  # the "container entrypoint"
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    # env overlay applied to attempts after the first: resume semantics —
    # a retried train job restarts *from its last checkpoint* instead of
    # from scratch (RunSpec.to_job fills this for resumable kinds)
    retry_env: Dict[str, str] = dataclasses.field(default_factory=dict)
    resources: Resources = dataclasses.field(default_factory=Resources)
    retries: int = 3
    # admission ordering for the real executor: higher runs first, FIFO
    # within a priority class (Kubernetes PriorityClass analogue)
    priority: int = 0
    # opt this job out of speculative duplicate launches (a job with
    # side effects beyond its checkpoint dir must not run twice at once)
    speculation: bool = True
    # >1: a gang-scheduled multi-process job (the Kubernetes Indexed-Job
    # analogue).  The executor places all `gang` ranks atomically — each
    # rank gets its own `resources` request — or none, and one rank's
    # death kills and requeues the whole gang.
    gang: int = 1
    # elastic-gang floor: 0 (default) = rigid — a gang that no longer
    # fits waits or fails unschedulable; 1 <= gang_min < gang = the
    # executor may shrink a *requeued* gang's world to the largest
    # admissible size >= gang_min and resume it from the shared
    # rank-agnostic checkpoint instead of queueing at full size
    gang_min: int = 0
    # scheduler-sim fields: how long the job runs (the paper's Tables III/V
    # provide measured GPU-hours for the real workloads)
    duration_h: float = 1.0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def manifest(self) -> dict:
        """Kubernetes-Job-shaped manifest dict (see templating.render).
        Gang jobs render as Indexed Jobs: ``completions = parallelism =
        gang`` ranks, each addressed by its completion index."""
        gang = {}
        if self.gang > 1:
            gang = {"completionMode": "Indexed",
                    "completions": self.gang,
                    "parallelism": self.gang}
        return {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {"name": self.name, "labels": dict(self.labels)},
            "spec": {
                "backoffLimit": self.retries,
                **gang,
                "template": {
                    "spec": {
                        "containers": [{
                            "name": self.name,
                            "image": "repro/trainer:latest",
                            "env": [{"name": k, "value": str(v)}
                                    for k, v in sorted(self.env.items())],
                            "resources": {
                                "limits": {
                                    "nvidia.com/gpu": self.resources.gpus,
                                    "cpu": self.resources.cpus,
                                    "memory": f"{self.resources.memory_gb:g}Gi",
                                },
                            },
                        }],
                        "restartPolicy": "Never",
                    },
                },
            },
        }


@dataclasses.dataclass
class JobRecord:
    spec: JobSpec
    state: JobState = JobState.PENDING
    attempts: int = 0
    node: Optional[str] = None
    submit_time: float = 0.0
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    result: Any = None
    error: Optional[str] = None
    # observed-usage summary of the winning attempt (executor telemetry
    # sampler): samples, cpu_pct_mean/peak, rss_peak_mb, io_read/write_mb
    telemetry: Optional[Dict[str, Any]] = None

    @property
    def wall_h(self) -> Optional[float]:
        if self.start_time is None or self.end_time is None:
            return None
        return self.end_time - self.start_time

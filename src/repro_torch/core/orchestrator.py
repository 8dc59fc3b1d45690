"""The automation layer that ties grids, templates, scheduling and
execution together (the port's copy of ``repro.core.orchestrator``) — the
paper's bash scripts + kubectl, as a library (and exactly the "Kubernetes
Python API … Python library or application that can more easily and
reliably manage jobs" the paper names as future work).

Three execution modes:

* ``run_local``  — actually executes each job's Python payload (the
  port's training on the card, or on the CPU when the spec says
  ``device=cpu``), with retries and simulated preemption; manifests,
  per-experiment configs, logs and results land in the PersistentVolume,
  final artifacts in the S3Store — mirroring the paper's data flow (PVC
  staging -> train -> S3 export).
* ``run_cluster`` — real concurrent execution of every job as a
  ``python -m repro_torch.launch run <kind>`` subprocess.  It needs the
  campaign executor, which is not ported yet, and raises.
* ``simulate``   — schedules the same jobs on a ClusterSim inventory and
  returns makespan/utilization (used to validate the paper's Tables III/V
  accounting).
"""
from __future__ import annotations

import json
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.artifacts import PersistentVolume, S3Store
from repro_torch.core.jobs import JobRecord, JobSpec, JobState
from repro_torch.core.scheduler import ClusterSim, NodeSpec, SimResult
from repro_torch.core.templating import render_job_manifest, to_yaml


def _registry_payload() -> Callable[..., Any]:
    """Container semantics for locally executed RunSpec jobs: the payload
    sees only its env, rebuilds the spec, and runs it through the
    ``repro_torch.api`` registry; a failed RunReport raises so the
    orchestrator's retry/fault accounting still applies."""
    def payload(**env):
        from repro_torch.api import RunSpec
        from repro_torch.api import run as api_run
        report = api_run(RunSpec.from_env(env))
        if not report.ok:
            raise RuntimeError(report.error or f"{report.name} failed")
        return report
    return payload


def _resumed_from_step(result: Any) -> Optional[int]:
    """Pull ``resumed_from_step`` out of a payload result (RunReport or
    plain dict) without importing repro_torch.api: the attempt history records
    where a resumed attempt picked up."""
    metrics = getattr(result, "metrics", None)
    if metrics is None and isinstance(result, dict):
        metrics = result.get("metrics", result)
    if isinstance(metrics, dict):
        val = metrics.get("resumed_from_step")
        if val is not None:
            return int(val)
    return None


def _jsonable(result: Any) -> Any:
    """Uniform serialization: RunReports (and anything exposing
    ``to_dict``) become plain dicts before landing in PVC/S3."""
    to_dict = getattr(result, "to_dict", None)
    return to_dict() if callable(to_dict) else result


class Orchestrator:
    def __init__(self, pvc: PersistentVolume, s3: Optional[S3Store] = None,
                 inventory: Optional[Sequence[NodeSpec]] = None,
                 seed: int = 0):
        self.pvc = pvc
        self.s3 = s3
        self.inventory = inventory
        self.seed = seed
        self.records: Dict[str, JobRecord] = {}

    # ------------------------------------------------------------------
    def submit(self, job: JobSpec) -> JobRecord:
        """Register a job: write its manifest + config to the PVC (the
        paper auto-generates all manifests before any submission)."""
        if job.name in self.records:
            raise ValueError(f"duplicate job name {job.name}")
        rec = JobRecord(spec=job, submit_time=time.time())
        self.records[job.name] = rec
        manifest = render_job_manifest(
            job.name, experiment=job.labels.get("experiment", "default"),
            env=job.env, gpus=job.resources.gpus, cpus=job.resources.cpus,
            memory_gb=job.resources.memory_gb, retries=job.retries)
        self.pvc.stage_bytes(f"manifests/{job.name}.yaml",
                             to_yaml(manifest).encode())
        return rec

    def submit_many(self, jobs: Sequence[JobSpec]) -> List[JobRecord]:
        return [self.submit(j) for j in jobs]

    def submit_runs(self, runs: Sequence[Any],
                    attach_payload: bool = False) -> List[JobRecord]:
        """Submit ``repro_torch.api.RunSpec``s directly: each becomes a JobSpec
        whose manifest env is the spec's bash-style encoding.  With
        ``attach_payload`` the job executes through the runner registry
        (container semantics: the payload rebuilds the spec from env and
        returns a RunReport dict)."""
        jobs = []
        for run in runs:
            payload = _registry_payload() if attach_payload else None
            jobs.append(run.to_job(payload=payload))
        return self.submit_many(jobs)

    # ------------------------------------------------------------------
    def run_local(self, parallelism: int = 1,
                  fail_fast: bool = False) -> Dict[str, JobRecord]:
        """Execute payloads (in submission order; payloads run
        sequentially on this host, but `parallelism` drives simulated
        lane accounting — each job is placed on the earliest-free of
        `parallelism` lanes, and the resulting **simulated** makespan is
        recorded as ``simulated_makespan_s`` in
        ``results/_local_run_summary.json`` — never as ``makespan_s``,
        which is reserved for the *real* wall-clock campaign makespan
        :meth:`run_cluster` measures).

        State transitions are monotonic per job: PENDING -> RUNNING once,
        then exactly one final state after all attempts.  Every attempt
        is recorded — failures as ``logs/<job>.attempt<N>.log``, and the
        full per-attempt history in the job's result JSON.
        """
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {parallelism}")
        lanes = [0.0] * parallelism          # simulated busy-time per lane
        pending = [r for r in self.records.values()
                   if r.state == JobState.PENDING]
        for rec in pending:
            job = rec.spec
            rec.state = JobState.RUNNING     # PENDING -> RUNNING, once
            rec.start_time = time.time()
            attempt_history = []
            result, error = None, None
            for attempt in range(1 + job.retries):
                rec.attempts = attempt + 1
                t_attempt = time.time()
                # retries run with the resume overlay (when the job has
                # one): the payload restarts from its last checkpoint
                env = (job.env if attempt == 0 or not job.retry_env
                       else {**job.env, **job.retry_env})
                try:
                    result = job.payload(**env) if job.payload else None
                    error = None
                    entry = {"attempt": rec.attempts, "outcome": "succeeded",
                             "wall_s": time.time() - t_attempt}
                    resumed = _resumed_from_step(result)
                    if resumed is not None:
                        entry["resumed_from_step"] = resumed
                    attempt_history.append(entry)
                    break
                except Exception as e:  # noqa: BLE001 — job-level fault barrier
                    error = f"{type(e).__name__}: {e}"
                    attempt_history.append(
                        {"attempt": rec.attempts, "outcome": "failed",
                         "wall_s": time.time() - t_attempt, "error": error})
                    self.pvc.stage_bytes(
                        f"logs/{job.name}.attempt{rec.attempts}.log",
                        traceback.format_exc().encode())
                    if fail_fast:
                        rec.end_time = time.time()
                        rec.error = error
                        rec.state = JobState.FAILED
                        raise
            # RUNNING -> final, once, after the retry loop
            rec.end_time = time.time()
            rec.error = error
            rec.result = result
            rec.state = (JobState.SUCCEEDED if error is None
                         else JobState.FAILED)
            lane = min(range(parallelism), key=lanes.__getitem__)
            lanes[lane] += rec.end_time - rec.start_time
            rec.node = f"lane{lane}"
            payload_json = _jsonable(result)
            self.pvc.stage_json(
                f"results/{job.name}.json",
                {"job": job.name, "state": rec.state.value,
                 "attempts": rec.attempts,
                 "attempt_history": attempt_history,
                 "wall_s": rec.end_time - rec.start_time,
                 "lane": lane, "error": error, "result": payload_json})
            if self.s3 is not None and rec.state == JobState.SUCCEEDED:
                self.s3.put_bytes(
                    f"results/{job.name}.json",
                    json.dumps({"result": payload_json},
                               default=str).encode())
        if pending:
            self.pvc.stage_json("results/_local_run_summary.json", {
                "parallelism": parallelism,
                "jobs": len(pending),
                "serial_s": sum(lanes),
                # deliberately NOT named ``makespan_s``: that key means
                # real wall-clock in _campaign_summary.json /
                # BENCH_campaign.json, while this one is simulated lane
                # accounting — the names must never collide
                "simulated_makespan_s": max(lanes),
                "lane_busy_s": lanes,
            })
        return self.records

    # ------------------------------------------------------------------
    def run_cluster(self, workers: int = 1, *, inventory=None,
                    **executor_kw) -> Dict[str, JobRecord]:
        """Execute the pending jobs as real concurrent ``python -m
        repro_torch.launch run <kind>`` subprocesses under resource-aware
        admission.  That is the campaign executor's work, which is not
        ported yet."""
        raise NotImplementedError(
            "run_cluster needs the campaign executor, which is not ported "
            "yet; use run_local (or simulate)")

    # ------------------------------------------------------------------
    def simulate(self, preemption_rate: float = 0.0,
                 checkpoint_every_h: float = 0.0,
                 placement=None) -> SimResult:
        """Schedule the submitted jobs on the cluster sim.  With
        ``checkpoint_every_h`` the jobs are modeled as durable-checkpoint
        trainers: preemption loses only the work since the last
        checkpoint, not the attempt (see :class:`ClusterSim`).
        ``placement`` selects a :class:`repro_torch.core.placement
        .PlacementPolicy` by the same names ``run_cluster`` accepts."""
        sim = ClusterSim(self.inventory, seed=self.seed,
                         preemption_rate=preemption_rate,
                         checkpoint_every_h=checkpoint_every_h,
                         placement=placement)
        return sim.run([r.spec for r in self.records.values()])

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        states = {}
        for r in self.records.values():
            states[r.state.value] = states.get(r.state.value, 0) + 1
        return {
            "jobs": len(self.records),
            "states": states,
            "manifests": len(self.pvc.listdir("manifests")),
        }

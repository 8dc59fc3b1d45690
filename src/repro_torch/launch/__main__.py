"""The one dispatching CLI: ``python -m repro_torch.launch run <kind> ...``
(the port's copy of ``repro.launch.__main__``).

Every workload goes through the same door:

    python -m repro_torch.launch run train     --arch stablelm-1.6b --steps 50
    python -m repro_torch.launch run serve     --arch granite-3-2b --requests 8
    python -m repro_torch.launch run simulate  --campaign burned_area
    python -m repro_torch.launch run dryrun    --arch all --shape train_4k
    python -m repro_torch.launch run perfprobe --arch glm4-9b --shape decode_32k
    python -m repro_torch.launch campaign run --jobs jobs.json --workdir DIR
    python -m repro_torch.launch campaign status [events.jsonl | workdir]
    python -m repro_torch.launch kinds

``run`` builds a :class:`repro_torch.api.RunSpec` from the argv (known
flags: ``--arch/--seed/--name``; any other ``--key value`` becomes an
override), dispatches through the runner registry, prints the
:class:`repro_torch.api.RunReport` as JSON, and exits nonzero iff the
run failed (1), or with 2 for an unknown kind or malformed flags.
``train`` and ``serve`` run on the card unless ``--device cpu`` says
otherwise.  The per-kind module entry points
(``python -m repro_torch.launch.train`` etc.) are thin shims over this
same registry.

``dryrun`` builds each (arch x shape) step on the ``meta`` device and
counts its FLOPs and bytes for one card, and traces one rank of the
production mesh (``--mesh single|multi|both``: 16x16 or 2x16x16) under
``--layout`` (nothing is allocated, no card is needed); ``perfprobe``
runs one cell on the card at the batch the dry run says fits it
(``--device cpu`` for a CPU run), with ``--world_size N`` self-gangs N
ranks on a grid of ``--pod`` pods and a ``--model`` axis: ``fsdp_tp``
(the default) and ``fsdp_sp`` shard the parameters, ``dp`` replicates
them; ``--multi-pod`` traces one rank of the two-pod mesh on ``meta``
and runs nothing.

``campaign run`` drives a whole campaign from a jobs file (a JSON list
of RunSpec dicts): it submits every spec to an Orchestrator and executes
them with ``run_cluster`` — this process *is* the scheduler, so chaos
tests SIGKILL it and restart with ``--resume-campaign`` to exercise
crash recovery (completed jobs are never re-executed; live orphan
attempts are re-adopted by pid + start-time identity).  Knobs:
``--workers``, ``--speculate`` (straggler duplicates), ``--backfill``,
``--pin-cpus``, ``--attempt-timeout``, ``--no-telemetry``,
``--retry-backoff-base``.  Prints the campaign summary JSON; exits
nonzero unless every job succeeded.  Each job runs as a ``python -m
repro_torch.launch run <kind>`` subprocess, on the card unless its spec
says ``device=cpu``; the scheduler itself imports no torch and holds no
card memory.

``campaign status`` replays a ``run_cluster`` campaign's durable event
log (``campaign/events.jsonl``) into a per-job state table — pass the
events file or any directory to search (default ``experiments``).  Add
``--json`` for the machine-readable replay (including each job's
telemetry summary: peak RSS, mean/peak CPU%, declared-vs-observed
request ratio).  Exits 1 if the log replays to an inconsistent state,
2 if there is no log.
"""
from __future__ import annotations

import os
import sys

_USAGE = __doc__.split("\n\n")[1]


def _apply_cpu_affinity() -> None:
    """Honor a campaign executor's CPU limit (``REPRO_CPU_AFFINITY``,
    the local analogue of a Kubernetes CPU limit) before torch — and its
    thread pools — load."""
    spec = os.environ.get("REPRO_CPU_AFFINITY")
    if spec and hasattr(os, "sched_setaffinity"):
        try:
            os.sched_setaffinity(0, {int(c) for c in spec.split(",") if c})
        except (ValueError, OSError):
            pass                      # stale/foreign core list: run unpinned


def main(argv=None) -> int:
    _apply_cpu_affinity()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(f"usage: python -m repro_torch.launch <run|campaign|kinds> ..."
              f"\n\n{_USAGE}")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "kinds":
        from repro_torch.api import runner_kinds
        print("\n".join(runner_kinds()))
        return 0
    if cmd == "campaign":
        return _campaign(rest)
    if cmd != "run":
        print(f"unknown command {cmd!r} (expected 'run', 'campaign' "
              f"or 'kinds')", file=sys.stderr)
        return 2
    if not rest:
        print("usage: python -m repro_torch.launch run <kind> [flags]",
              file=sys.stderr)
        return 2

    from repro_torch.api import RunSpec, run
    try:
        spec = RunSpec.from_args(rest)
        report = run(spec)
    except (KeyError, ValueError) as e:   # unknown kind / malformed flags
        print(str(e).strip('"'), file=sys.stderr)
        return 2
    print(report.to_json())
    return 0 if report.ok else 1


def _campaign(rest) -> int:
    """``campaign run|status ...`` — drive or inspect a campaign (no torch
    import on either path: the scheduler process stays lightweight and
    creates no CUDA context)."""
    import json
    from repro_torch.core.executor import (find_events_file,
                                           format_status, replay_events)
    if rest and rest[0] == "run":
        return _campaign_run(rest[1:])
    if not rest or rest[0] != "status":
        print("usage: python -m repro_torch.launch campaign "
              "{run --jobs FILE --workdir DIR | status "
              "[events.jsonl | dir] [--json]}", file=sys.stderr)
        return 2
    args = [a for a in rest[1:] if a != "--json"]
    as_json = "--json" in rest
    target = args[0] if args else "experiments"
    events = find_events_file(target)
    if events is None:
        print(f"no campaign event log found under {target!r} "
              f"(looked for events.jsonl)", file=sys.stderr)
        return 2
    with open(events, encoding="utf-8") as fh:
        state = replay_events(fh)
    if as_json:
        print(json.dumps(state, indent=1, sort_keys=True, default=str))
    else:
        print(f"# {events}")
        print(format_status(state))
    return 0 if state["consistent"] else 1


def _campaign_run(rest) -> int:
    """``campaign run --jobs FILE --workdir DIR [knobs]`` — this process
    is the campaign scheduler (the SIGKILL target of the scheduler-chaos
    tests; restart with ``--resume-campaign`` to recover)."""
    import argparse
    import json
    from pathlib import Path

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch campaign run", add_help=True)
    ap.add_argument("--jobs", required=True,
                    help="JSON file: a list of RunSpec dicts")
    ap.add_argument("--workdir", required=True,
                    help="campaign root (PVC mount)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--speculate", action="store_true",
                    help="first-finisher-wins straggler duplicates")
    ap.add_argument("--backfill", action="store_true",
                    help="small jobs may pass a blocked queue head "
                         "(never delaying its earliest feasible start)")
    ap.add_argument("--resume", "--resume-campaign", action="store_true",
                    dest="resume",
                    help="replay campaign/events.jsonl: keep completed "
                         "work, adopt live orphans, re-queue dead ones")
    ap.add_argument("--pin-cpus", action="store_true")
    ap.add_argument("--attempt-timeout", type=float, default=None)
    ap.add_argument("--no-telemetry", action="store_true")
    ap.add_argument("--retry-backoff-base", type=float, default=1.0)
    ap.add_argument("--grace", type=float, default=5.0, metavar="S",
                    help="SIGTERM->SIGKILL escalation window for "
                         "evictions, drains and speculation kills "
                         "(the pod terminationGracePeriod analogue)")
    ap.add_argument("--preempt", action="store_true",
                    help="preempting scheduler class: a high-priority "
                         "queue head evicts (checkpoint + free requeue) "
                         "lower-priority running attempts when their "
                         "release makes it placeable")
    ap.add_argument("--placement", default="best_fit",
                    help="placement policy ordering candidate nodes: "
                         "best_fit (default), worst_fit, or pack — the "
                         "same names `simulate` accepts, so a policy "
                         "evaluated in the sim is the one run here")
    ap.add_argument("--nodes-file", default=None, metavar="FILE",
                    help="watched node-inventory control file "
                         "(default WORKDIR/campaign/nodes.json): "
                         "rewrite it mid-campaign to grow the pool or "
                         "drain+remove nodes")
    ap.add_argument("--chaos-kill", default=None, metavar="NAME[,NAME]",
                    help="kill these jobs mid-run (a gang job loses "
                         "ONE rank) to exercise the requeue+resume path")
    ap.add_argument("--chaos-signal", default="kill",
                    choices=("kill", "term"),
                    help="chaos kill signal: 'kill' = SIGKILL (lose "
                         "work since the last cadence checkpoint), "
                         "'term' = SIGTERM (the handler salvages a "
                         "final checkpoint first)")
    ap.add_argument("--chaos-after-checkpoints", type=int, default=1,
                    help="fire each chaos kill once the victim has "
                         "published this many checkpoints (0: kill on "
                         "liveness instead)")
    ns = ap.parse_args(rest)

    # repro_torch.api.spec is torch-free; the scheduler never loads an
    # ML stack and creates no CUDA context
    from repro_torch.api.spec import RunSpec
    from repro_torch.core.artifacts import PersistentVolume
    from repro_torch.core.jobs import JobState
    from repro_torch.core.orchestrator import Orchestrator

    entries = json.loads(Path(ns.jobs).read_text(encoding="utf-8"))
    if not isinstance(entries, list):
        print(f"{ns.jobs}: expected a JSON list of RunSpec dicts",
              file=sys.stderr)
        return 2
    runs = [RunSpec.from_dict(e) for e in entries]
    extra = {}
    if ns.chaos_kill:
        import signal as _sig
        from repro_torch.core.executor import ChaosSpec
        extra["chaos"] = ChaosSpec(
            kill_jobs=tuple(n for n in ns.chaos_kill.split(",") if n),
            after_checkpoints=ns.chaos_after_checkpoints,
            signal=int(_sig.SIGTERM if ns.chaos_signal == "term"
                       else _sig.SIGKILL))
    orch = Orchestrator(PersistentVolume(ns.workdir))
    orch.submit_runs(runs)
    orch.run_cluster(
        workers=ns.workers, resume=ns.resume, speculate=ns.speculate,
        backfill=ns.backfill, pin_cpus=ns.pin_cpus,
        telemetry=not ns.no_telemetry,
        attempt_timeout_s=ns.attempt_timeout,
        retry_backoff_base_s=ns.retry_backoff_base,
        grace_s=ns.grace, preempt=ns.preempt,
        placement=ns.placement,
        nodes_file=ns.nodes_file, **extra)
    print(json.dumps(orch.last_campaign_summary, indent=1,
                     sort_keys=True, default=str))
    return 0 if all(r.state == JobState.SUCCEEDED
                    for r in orch.records.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())

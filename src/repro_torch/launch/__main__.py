"""The one dispatching CLI: ``python -m repro_torch.launch run <kind> ...``
(the port's copy of ``repro.launch.__main__``).

Every workload goes through the same door:

    python -m repro_torch.launch run train     --arch stablelm-1.6b --steps 50
    python -m repro_torch.launch run serve     --arch granite-3-2b --requests 8
    python -m repro_torch.launch run simulate  --campaign burned_area
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

``dryrun`` and ``perfprobe`` are registered, but they are tied to XLA and
their runners raise, so ``run`` reports them ``failed``.  ``campaign
run|status`` drive and inspect a campaign through the campaign executor,
which is not ported yet: they exit 2.
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
        print("campaign run|status needs the campaign executor, which is "
              "not ported yet", file=sys.stderr)
        return 2
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


if __name__ == "__main__":
    raise SystemExit(main())

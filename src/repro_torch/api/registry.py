"""Runner registry: kind -> Runner, plus the top-level ``run()`` (the
port's copy of ``repro.api.registry``).

A runner is anything with ``run(spec) -> RunReport`` — usually a plain
function registered via ``@register_runner(kind)``.  The five built-in
kinds are adapters over the launch bodies and are imported lazily, so
``import repro_torch.api`` imports no torch.

A kind may declare process-env prerequisites (``register_runner(...,
env=...)`` or ``_KIND_ENV`` for the lazy built-ins); ``run()`` applies
them with ``setdefault`` before the runner module loads.  No built-in
kind of the port declares one: the reference's only use, the XLA
fake-device flag of ``dryrun`` and ``perfprobe``, has no counterpart
here.

Adding a workload kind is one registry entry:

    from repro_torch.api import RunReport, register_runner

    @register_runner("evaluate")
    def run_evaluate(spec):
        ...
        return RunReport(kind="evaluate", name=spec.run_name, ...)
"""
from __future__ import annotations

import importlib
import os
import time
import traceback
from typing import Callable, Dict, List, Optional, Union

from repro_torch.api.report import FAILED, RunReport
from repro_torch.api.spec import RunSpec

RunnerFn = Callable[[RunSpec], RunReport]


class Runner:
    """Optional base class for stateful runners."""

    kind: str = ""

    def run(self, spec: RunSpec) -> RunReport:  # pragma: no cover
        raise NotImplementedError


_RUNNERS: Dict[str, Union[RunnerFn, Runner]] = {}

# Built-in kinds resolve on first use by importing the module that
# registers them (keeps ``import repro_torch.api`` free of torch).
_LAZY_BUILTINS = {
    "train": "repro_torch.api.runners.train",
    "serve": "repro_torch.api.runners.serve",
    "dryrun": "repro_torch.api.runners.dryrun",
    "perfprobe": "repro_torch.api.runners.perfprobe",
    "simulate": "repro_torch.api.runners.simulate",
}

# per-kind process-env prerequisites, applied (setdefault) by run()
# before the runner module loads
_KIND_ENV: Dict[str, Dict[str, str]] = {}


def register_runner(kind: str, runner: Union[RunnerFn, Runner, None] = None,
                    *, env: Optional[Dict[str, str]] = None):
    """Register a runner for ``kind``; usable as a decorator.  ``env``
    declares process-env defaults the kind needs in place before it
    first loads."""
    if env:
        _KIND_ENV[kind] = dict(env)
    if runner is not None:
        _RUNNERS[kind] = runner
        return runner

    def deco(fn):
        _RUNNERS[kind] = fn
        return fn
    return deco


def prepare_env(kind: str) -> None:
    """Apply a kind's declared env prerequisites (non-destructively)."""
    for key, val in _KIND_ENV.get(kind, {}).items():
        os.environ.setdefault(key, val)


def get_runner(kind: str) -> Union[RunnerFn, Runner]:
    if kind not in _RUNNERS and kind in _LAZY_BUILTINS:
        importlib.import_module(_LAZY_BUILTINS[kind])
    if kind not in _RUNNERS:
        raise KeyError(f"no runner registered for kind {kind!r}; "
                       f"known kinds: {runner_kinds()}")
    return _RUNNERS[kind]


def runner_kinds() -> List[str]:
    return sorted(set(_RUNNERS) | set(_LAZY_BUILTINS))


def run(spec: RunSpec) -> RunReport:
    """Execute a spec through its registered runner.

    Exceptions become a ``failed`` RunReport (the job-level fault barrier
    the orchestrator relies on); timing and spec provenance are filled in
    if the runner didn't.
    """
    prepare_env(spec.kind)
    runner = get_runner(spec.kind)
    call = runner.run if isinstance(runner, Runner) else runner
    t0 = time.time()
    try:
        report = call(spec)
    except Exception as e:  # noqa: BLE001 — uniform failure reporting
        return RunReport(
            kind=spec.kind, name=spec.run_name, status=FAILED,
            wall_s=round(time.time() - t0, 3),
            error=f"{type(e).__name__}: {e}",
            metrics={"traceback": traceback.format_exc()[-2000:]},
            spec=spec.to_dict())
    if not isinstance(report, RunReport):
        raise TypeError(f"runner for {spec.kind!r} returned "
                        f"{type(report).__name__}, expected RunReport")
    updates = {}
    if report.wall_s == 0.0:
        updates["wall_s"] = round(time.time() - t0, 3)
    if report.spec is None:
        updates["spec"] = spec.to_dict()
    return report.replace(**updates) if updates else report

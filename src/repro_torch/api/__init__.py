# The typed front door for every kind of run: RunSpec in, RunReport out
# (the port's copy of ``repro.api``).  This package imports no torch:
# runner adapters load lazily per kind (see registry._LAZY_BUILTINS), so
# ``run simulate`` and the campaign layer stay light.
from repro_torch.api.report import FAILED, SKIPPED, SUCCEEDED, RunReport
from repro_torch.api.registry import (Runner, get_runner, register_runner,
                                      run, runner_kinds)
from repro_torch.api.spec import KNOWN_KINDS, RunSpec, grid_to_runs

__all__ = [
    "RunSpec", "RunReport", "Runner",
    "register_runner", "get_runner", "run", "runner_kinds",
    "grid_to_runs", "KNOWN_KINDS",
    "SUCCEEDED", "FAILED", "SKIPPED",
]

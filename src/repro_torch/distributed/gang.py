"""Gang helpers and the local gang launcher: run a world-N training job
as N rank processes.

``run_gang_local`` is the path ``python -m repro_torch.launch run train
--world_size N`` takes when invoked *without* ``--dist_rank`` (a user at
a shell, or CI): the parent process stays torch-free, spawns one ``run
train`` subprocess per rank with ``--dist_rank i --coordinator
127.0.0.1:<port>`` appended, and adopts rank 0's RunReport as the job's
result.  The campaign executor does the same spawn itself (gang
admission needs per-rank process handles) with ``free_port`` and
``rank_argv``.  Nothing here imports torch: the executor's scheduler
process imports this module."""
from __future__ import annotations

import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

# seconds a surviving rank has to exit after SIGTERM before SIGKILL
GRACE_S = 5.0


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind-to-0).  Racy by nature, but
    the coordinator binds immediately after."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def rank_argv(base_argv: List[str], rank: int, coordinator: str
              ) -> List[str]:
    """Append the per-rank distributed flags to a ``run train`` argv."""
    return list(base_argv) + [f"--dist_rank={rank}",
                              f"--coordinator={coordinator}"]


def _src_path() -> str:
    # .../src/repro_torch/distributed/gang.py -> .../src
    return str(Path(__file__).resolve().parents[2])


def run_gang_local(spec, world: int) -> Dict[str, Any]:
    """Spawn ``world`` rank subprocesses for ``spec`` (a train RunSpec
    whose overrides carry ``world_size``), wait for the gang, and
    return rank 0's report metrics plus a ``gang`` section.  Any rank
    failing fails the gang (gang semantics, not straggler tolerance):
    the others get SIGTERM, then SIGKILL after ``GRACE_S``.  The ranks'
    output goes to a temporary directory, removed when every rank
    succeeded and kept (and named in the error) when one failed.  The
    ranks share this process's process group, so a caller that kills
    the group stops them too.
    """
    from repro_torch.api.spec import _encode_scalar
    from repro_torch.core.executor import parse_trailing_report

    coordinator = f"127.0.0.1:{free_port()}"
    base = [sys.executable, "-m", "repro_torch.launch", "run", spec.kind,
            "--arch", spec.arch, "--seed", str(spec.seed),
            "--name", spec.run_name]
    for key, val in sorted(spec.overrides.items()):
        if key in ("dist_rank", "coordinator"):
            continue
        base.append(f"--{key}={_encode_scalar(val)}")

    env = dict(os.environ)
    src = _src_path()
    existing = env.get("PYTHONPATH", "")
    if src not in existing.split(os.pathsep):
        env["PYTHONPATH"] = src + os.pathsep + existing if existing else src

    logs = Path(tempfile.mkdtemp(prefix=f"gang-{spec.run_name}-"))
    procs, outs = [], []
    for r in range(world):
        out_p = logs / f"rank{r}.out"
        outs.append(out_p)
        with open(out_p, "wb") as out, \
                open(logs / f"rank{r}.err", "wb") as err:
            procs.append(subprocess.Popen(
                rank_argv(base, r, coordinator), env=env, stdout=out,
                stderr=err))
    rcs: List[Optional[int]] = [None] * world
    try:
        # poll every rank: the first that fails condemns the gang, and a
        # survivor blocked in a collective is not waited for
        while any(rc is None for rc in rcs):
            for r, p in enumerate(procs):
                if rcs[r] is None:
                    rcs[r] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.05)
    finally:
        # graceful teardown of stragglers: SIGTERM (the coordinator's
        # handler flushes a final checkpoint), a shared grace deadline,
        # then SIGKILL — the same escalation the executor applies
        live = [r for r, p in enumerate(procs) if p.poll() is None]
        for r in live:
            procs[r].send_signal(signal.SIGTERM)
        grace_end = time.monotonic() + GRACE_S
        for r in live:
            try:
                rcs[r] = procs[r].wait(
                    timeout=max(0.0, grace_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                procs[r].send_signal(signal.SIGKILL)
                rcs[r] = procs[r].wait()
        for r, p in enumerate(procs):
            if rcs[r] is None:
                rcs[r] = p.returncode
    if any(rc != 0 for rc in rcs):
        bad = next(r for r, rc in enumerate(rcs) if rc != 0)
        # a rank whose run failed printed a report with its error
        report = parse_trailing_report(
            outs[bad].read_text(errors="replace")) or {}
        err_tail = (logs / f"rank{bad}.err").read_text(
            errors="replace")[-2000:]
        raise RuntimeError(
            f"gang rank {bad}/{world} exited rc={rcs[bad]} "
            f"(all rcs={rcs}); its error: {report.get('error')}; logs in "
            f"{logs}; stderr tail:\n{err_tail}")
    reports = [parse_trailing_report(out.read_text(errors="replace"))
               for out in outs]
    for r, report in enumerate(reports):
        if report is None or report.get("status") == "failed":
            raise RuntimeError(f"gang rank {r} produced no usable "
                               f"RunReport (see {outs[r]})")
    shutil.rmtree(logs, ignore_errors=True)
    metrics = dict(reports[0].get("metrics") or {})
    # every rank's own dist section (its device, peak memory, kernel
    # launches and all-reduce time) beside rank 0's report
    metrics["gang"] = {"world_size": world, "coordinator": coordinator,
                       "returncodes": rcs,
                       "ranks": [(rep.get("metrics") or {}).get("dist")
                                 for rep in reports]}
    return metrics

"""The port's campaign executor against the reference's, decision for
decision.  Both executors run the same campaign (the same jobs, built
through each package's own ``RunSpec``, the same inventory and knobs, the
same fake process plan, a fresh tick clock each) in two roots.  Then:

* the event logs are equal line for line, once the port's root is
  mapped onto the reference's;
* the argv each spawned process was given is equal, once
  ``repro_torch.launch`` is mapped onto ``repro.launch``;
* the campaign summaries and per-job results are equal;
* each package's ``replay_events`` gives the same state on either log,
  and ``format_status`` the same text;
* a scheduler crash at any line (the log truncated there) resumes to
  the same continuation under both;
* ``job_run_argv`` equals the reference's for random specs.

Campaigns are drawn from seeds (hypothesis): retries, failures, SIGKILL
and SIGTERM preemptions, timeouts, priorities, backoff, backfill, the
preempting class, speculative duplicates, the three placement policies,
chaos kills, gangs with a rank death, and a ``nodes.json`` drain."""
import json
import random
import signal
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

import repro.api as ref_api  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.core.executor as ref_ex  # noqa: E402
import repro_torch.api as port_api  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.executor as port_ex  # noqa: E402

REF, PORT = (ref_api, ref_core, ref_ex), (port_api, port_core, port_ex)


class TickClock:
    """Every observation advances time a little (as in the reference's
    executor tests), so both executors see the same timestamps."""

    def __init__(self, start=1_000.0, tick=0.01):
        self.t, self.tick = start, tick

    def __call__(self):
        self.t += self.tick
        return self.t


class PlanProc:
    """Popen-shaped fake: ``poll()`` returns None ``ticks`` times, then
    writes a RunReport (on rc 0) and returns ``rc``.  ``pid`` is None so
    nothing real is ever signalled or adopted."""

    pid = None

    def __init__(self, job, attempt, stdout_fh, rc, ticks, ignore_term):
        self.job, self.attempt = job, attempt
        self.stdout_fh = stdout_fh
        self.rc, self.ticks = rc, ticks
        self.ignore_term = ignore_term

    def poll(self):
        self.ticks -= 1
        if self.ticks > 0:
            return None
        if self.rc == 0:
            report = {"kind": "train", "name": self.job.name,
                      "status": "succeeded",
                      "metrics": {"resumed_from_step":
                                  2 if self.attempt > 1 else None}}
            self.stdout_fh.write(json.dumps(report, indent=1).encode())
            self.stdout_fh.flush()
        return self.rc

    def send_signal(self, sig):
        if sig == int(signal.SIGTERM) and self.ignore_term:
            return
        self.rc, self.ticks = -int(sig), 1


def _rank(argv):
    return next((int(a.split("=")[1]) for a in argv
                 if a.startswith("--dist_rank=")), 0)


def draw_campaign(seed):
    """A campaign as plain data, so both packages build it the same
    way."""
    rng = random.Random(seed)
    n = rng.randint(2, 6)
    jobs, plan = [], {}
    for i in range(n):
        name = f"j{i}"
        overrides = {"steps": rng.choice([2, 4, 8]),
                     "lr": rng.choice([1e-4, 3e-4])}
        if rng.random() < 0.5:
            overrides["checkpoint_dir"] = f"ck/{name}"
        if rng.random() < 0.2:
            overrides["world_size"] = 2
            if rng.random() < 0.5:
                overrides["gang_min"] = 1
        jobs.append({
            "name": name, "seed": i, "overrides": overrides,
            "priority": rng.choice([0, 0, 1, 5]),
            "retries": rng.choice([1, 2, 3]),
            "resources": {"gpus": rng.choice([0, 1, 1, 2]),
                          "cpus": rng.choice([1, 2, 4]),
                          "memory_gb": rng.choice([2.0, 8.0, 24.0])}})
        # per-attempt (rc, ticks); a rank-1 death for gang attempts
        plan[name] = [(rng.choice([0, 0, 0, 1, -int(signal.SIGKILL),
                                   -int(signal.SIGTERM)]),
                       rng.choice([rng.randint(1, 30), rng.randint(1, 30),
                                   200])) for _ in range(4)]
    knobs = {
        "workers": rng.randint(1, 4),
        "backfill": rng.random() < 0.5,
        "preempt": rng.random() < 0.3,
        "speculate": rng.random() < 0.3,
        "placement": rng.choice(["best_fit", "worst_fit", "pack"]),
        "retry_backoff_base_s": rng.choice([0.0, 0.05]),
        "backoff_seed": rng.randint(0, 9),
        "attempt_timeout_s": rng.choice([None, None, 0.5]),
        "grace_s": rng.choice([0.05, 5.0]),
    }
    inventory = [
        {"name": "small", "gpus": 2, "gpu_memory_gb": 11, "cpus": 4,
         "memory_gb": 24, "count": 1 + rng.randint(0, 1)},
        {"name": "big", "gpus": 4, "gpu_memory_gb": 48, "cpus": 8,
         "memory_gb": 64, "count": rng.randint(0, 1)}]
    chaos = None
    if rng.random() < 0.4:
        chaos = {"kill_jobs": sorted(rng.sample([j["name"] for j in jobs],
                                                k=rng.randint(1, 2))),
                 "after_checkpoints": 0, "after_s": 0.1,
                 "signal": int(rng.choice([signal.SIGKILL,
                                           signal.SIGTERM]))}
    drain_at = rng.choice([None, None, 40])
    return {"jobs": jobs, "plan": plan, "knobs": knobs,
            "inventory": inventory, "chaos": chaos, "drain_at": drain_at,
            "ignore_term": rng.random() < 0.3}


def run_campaign(pkg, root, camp, *, resume_log=None):
    """Run ``camp`` under one package's executor in ``root``; return the
    event lines, the spawned argvs, the summary and the results."""
    api, core, ex = pkg
    pvc = core.PersistentVolume(root)
    if resume_log is not None:
        path = pvc.path(ex.EVENTS_REL)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("".join(ln + "\n" for ln in resume_log))
    orch = core.Orchestrator(pvc)
    for j in camp["jobs"]:
        ov = dict(j["overrides"])
        if "checkpoint_dir" in ov:
            ov["checkpoint_dir"] = str(root / ov["checkpoint_dir"])
        job = api.RunSpec(kind="train", arch="stablelm-1.6b",
                          seed=j["seed"], name=j["name"],
                          overrides=ov).to_job()
        job.priority = j["priority"]
        job.retries = j["retries"]
        job.resources = core.Resources(**j["resources"])
        orch.submit(job)
    nodes_file = pvc.path("campaign/nodes.json")
    nodes_file.parent.mkdir(parents=True, exist_ok=True)
    nodes_file.write_text(json.dumps({"nodes": camp["inventory"]}))
    argvs, polls = [], [0]

    def maybe_drain():
        polls[0] += 1
        if polls[0] == camp["drain_at"]:
            nodes_file.write_text(json.dumps(
                {"nodes": camp["inventory"][:1]}))

    class Proc(PlanProc):
        def poll(self):
            maybe_drain()
            return super().poll()

    def spawn(job, attempt, argv, env, stdout_fh, stderr_fh):
        argvs.append(list(argv))
        steps = camp["plan"][job.name]
        rc, ticks = steps[min(attempt, len(steps)) - 1]
        if _rank(argv) == 0 and rc != 0 and "--dist_rank=0" in argv:
            rc = 0                       # in a gang, rank 1 dies
        return Proc(job, attempt, stdout_fh, rc, ticks,
                    camp["ignore_term"])

    kw = dict(camp["knobs"])
    if camp["chaos"]:
        kw["chaos"] = ex.ChaosSpec(**camp["chaos"])
    orch.run_cluster(spawn=spawn, poll_s=0.0, telemetry=False,
                     clock=TickClock(), resume=resume_log is not None,
                     nodes_file=str(nodes_file), **kw)
    lines = pvc.path(ex.EVENTS_REL).read_text().splitlines()
    results = {p.name: json.loads(p.read_text())
               for p in sorted(pvc.path("results").iterdir())}
    return lines, argvs, results


def _map(text, port_root, ref_root):
    return (text.replace(str(port_root), str(ref_root))
            .replace("repro_torch.launch", "repro.launch"))


def _argv(argv, port_root=None, ref_root=None):
    """An argv with the roots and module mapped, and the gang's
    rendezvous port (an OS-assigned free port) blanked."""
    out = []
    for a in argv:
        if port_root is not None:
            a = _map(a, port_root, ref_root)
        if a.startswith("--coordinator="):
            a = "--coordinator=127.0.0.1:PORT"
        out.append(a)
    return out


# the reference's executor runs a campaign under a limit of its own: a
# hang inside it (seen once, after a node was removed and two jobs were
# re-queued) fails that example with its seed, not the whole suite
REF_SECONDS = 120


def run_reference(root, camp, *, resume_log=None, seed=None):
    """:func:`run_campaign` under the reference's executor in a thread
    joined with a timeout of ``REF_SECONDS``; a campaign that has not
    ended by then fails with its seed.  The stuck thread is a daemon:
    nothing waits for it."""
    out = {}

    def target():
        try:
            out["value"] = run_campaign(REF, root, camp,
                                        resume_log=resume_log)
        except BaseException as e:          # re-raised below
            out["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(REF_SECONDS)
    if thread.is_alive():
        resumed = "" if resume_log is None else (
            f", resumed after {len(resume_log)} lines")
        pytest.fail(f"the reference's executor did not end the campaign "
                    f"of seed {seed} within {REF_SECONDS} s{resumed}")
    if "error" in out:
        raise out["error"]
    return out["value"]


def assert_same_campaign(tmp, camp, *, resume_log=None, seed=None):
    ref_root, port_root = tmp / "ref", tmp / "port"
    ref = run_reference(ref_root, camp, resume_log=resume_log, seed=seed)
    port = run_campaign(PORT, port_root, camp, resume_log=(
        None if resume_log is None
        else [_map(ln, ref_root, port_root) for ln in resume_log]))
    ref_lines, ref_argvs, ref_results = ref
    port_lines, port_argvs, port_results = port
    mapped = [_map(ln, port_root, ref_root) for ln in port_lines]
    assert len(mapped) == len(ref_lines)
    for i, (a, b) in enumerate(zip(ref_lines, mapped)):
        assert a == b, f"event line {i} differs"
    assert ([_argv(argv, port_root, ref_root) for argv in port_argvs]
            == [_argv(argv) for argv in ref_argvs])
    assert (json.loads(_map(json.dumps(port_results, sort_keys=True),
                            port_root, ref_root)) == ref_results)
    # each package's replay and status agree on either log
    state = ref_ex.replay_events(ref_lines)
    assert port_ex.replay_events(ref_lines) == state
    assert ref_ex.replay_events(mapped) == state
    assert port_ex.replay_events(mapped) == state
    assert port_ex.format_status(state) == ref_ex.format_status(state)
    assert state["ended"]
    return ref_lines


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_random_campaigns_log_equal_events(tmp_path_factory, seed):
    camp = draw_campaign(seed)
    assert_same_campaign(tmp_path_factory.mktemp("par"), camp, seed=seed)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), cut=st.integers(0, 10_000))
def test_resume_from_a_crash_at_any_line_continues_equally(
        tmp_path_factory, seed, cut):
    """The scheduler died after ``cut`` lines: both executors replay the
    same prefix, re-queue the same orphans and finish the same way."""
    camp = draw_campaign(seed)
    lines = assert_same_campaign(tmp_path_factory.mktemp("full"), camp,
                                 seed=seed)
    cut %= len(lines) + 1
    assert_same_campaign(tmp_path_factory.mktemp("resumed"), camp,
                         resume_log=lines[:cut], seed=seed)


@pytest.mark.parametrize("which", ["chaos", "gang", "drain", "evict"])
def test_named_scenarios_log_equal_events(tmp_path, which):
    """One fixed campaign per feature, so each is covered whatever the
    random draws are."""
    camp = draw_campaign(11)
    camp.update(chaos=None, drain_at=None, ignore_term=False)
    for j in camp["jobs"]:
        j["overrides"].pop("world_size", None)
    ok = [(0, 3)] * 4
    camp["plan"] = {j["name"]: list(ok) for j in camp["jobs"]}
    if which == "chaos":
        camp["chaos"] = {"kill_jobs": [camp["jobs"][0]["name"]],
                         "after_checkpoints": 0, "after_s": 0.05,
                         "signal": int(signal.SIGKILL)}
        camp["plan"][camp["jobs"][0]["name"]] = [(0, 200)] + [(0, 3)] * 3
    elif which == "gang":
        camp["jobs"][0]["overrides"]["world_size"] = 2
        camp["jobs"][0]["resources"] = {"gpus": 1, "cpus": 1,
                                        "memory_gb": 2.0}
        camp["knobs"]["workers"] = 2
        camp["plan"][camp["jobs"][0]["name"]] = \
            [(-int(signal.SIGKILL), 5)] + [(0, 3)] * 3
    elif which == "drain":
        camp["drain_at"] = 5
        camp["inventory"][1]["count"] = 1
        camp["plan"] = {j["name"]: [(0, 20)] * 4 for j in camp["jobs"]}
    else:
        # the head fails once and backs off; two low-priority jobs fill
        # both slots, one before and one after the failure; when the
        # head's gate opens it evicts the newer of them
        camp["knobs"].update(preempt=True, workers=2,
                             retry_backoff_base_s=2.0)
        camp["inventory"] = [{"name": "w", "gpus": 2, "gpu_memory_gb": 80,
                              "cpus": 8, "memory_gb": 64, "count": 1}]
        camp["jobs"] = camp["jobs"][:3]
        for j, prio in zip(camp["jobs"], (5, 0, 0)):
            j["priority"] = prio
            j["resources"] = {"gpus": 1, "cpus": 1, "memory_gb": 2.0}
        hi, lo0, lo1 = (j["name"] for j in camp["jobs"])
        camp["plan"] = {hi: [(1, 3)] + [(0, 3)] * 3,
                        lo0: [(0, 600)] + [(0, 3)] * 3,
                        lo1: [(0, 600)] + [(0, 3)] * 3}
    lines = assert_same_campaign(tmp_path, camp)
    events = {json.loads(ln)["event"] for ln in lines}
    want = {"chaos": "chaos_kill", "gang": "rank_exited",
            "drain": "node_draining", "evict": "evict"}[which]
    assert want in events, sorted(events)
    if which == "evict":
        ev = next(json.loads(ln) for ln in lines
                  if json.loads(ln)["event"] == "evict")
        assert ev["job"] == camp["jobs"][2]["name"]    # newest first


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_job_run_argv_matches_the_reference(seed):
    rng = random.Random(seed)
    kind = rng.choice(["train", "serve"])
    overrides = {}
    for key, vals in (("steps", [1, 4, 100]), ("lr", [1e-4, 3e-4]),
                      ("batch", [2, 8]), ("precision", ["f32", "bf16"]),
                      ("checkpoint_dir", ["/tmp/ck a", "/x/y"]),
                      ("requests", [2, 8]), ("device", ["cpu", "cuda"]),
                      ("full", [True, False]), ("grad_clip", [None, 1.0]),
                      ("world_size", [1, 2])):
        if rng.random() < 0.5:
            overrides[key] = rng.choice(vals)
    args = dict(kind=kind, arch=rng.choice(["stablelm-1.6b",
                                            "granite-3-2b"]),
                seed=rng.randint(0, 99), name=f"n{seed % 7}",
                overrides=overrides)
    ref_job = ref_api.RunSpec(**args).to_job()
    port_job = port_api.RunSpec(**args).to_job()
    overlay = rng.choice([None, {"CHECKPOINT_DIR": "/sib.spec2"},
                          {"WORLD_SIZE": "1"}])
    for resume in (False, True):
        assert (port_ex.job_run_argv(port_job, resume=resume,
                                     env_overlay=overlay)
                == ref_ex.job_run_argv(ref_job, resume=resume,
                                       env_overlay=overlay))

"""train runner: adapts :func:`repro_torch.launch.train.train_main` (the
port's copy of ``repro.api.runners.train``).

A spec written for the reference runs unchanged: its backend names
(``jnp`` | ``pallas`` | ``auto``) map onto the port's (``torch`` |
``cuda`` | ``auto``), and the port's own names are accepted too.  One
override is the port's own: ``device`` (default ``None``: ``cuda``, which
must exist; the tests pass ``cpu``).  It travels through the env manifest
like any override, so a ``run_local`` job on the CPU stays there.
Data-parallel gangs (``world_size > 1``, ``dist_rank``, ``coordinator``)
wait for the port of ``distributed/`` and raise.
"""
from __future__ import annotations

import time

from repro_torch.api.report import RunReport
from repro_torch.api.registry import register_runner
from repro_torch.api.spec import RunSpec

DEFAULTS = {
    "full": False,          # full-size config instead of reduced
    "steps": 100,
    "batch": 8,
    "seq": 128,
    "lr": 3e-4,
    "optimizer": None,
    "checkpoint_dir": None,
    "checkpoint_every": 0,   # full-TrainState save cadence (steps); 0 = end only
    "checkpoint_keep": 3,    # keep-last-N rotation
    "checkpoint_async": True,  # background-thread saves off the hot path
    "resume": False,         # restore newest valid checkpoint before training
    "preempt_at_step": None,  # fault hook: raise Preemption before this step
    "s3_root": None,
    "log_every": 10,
    "precision": "f32",       # mixed-precision policy (f32 | bf16)
    "grad_clip": None,        # clip global grad norm (fused with the metric)
    "attention_backend": None,  # torch | cuda | auto, or the reference's
    "mixer_backend": None,      # jnp | pallas (None = config default)
    # -- data-parallel: batch is the GLOBAL batch; not ported yet --
    "world_size": 1,          # >1 = N-process data-parallel gang
    "gang_min": 0,            # elastic floor, read by the campaign executor
    "dist_rank": None,        # set per rank by the gang launcher/executor
    "coordinator": None,      # host:port of rank 0
    "microbatches": 1,        # grad-accumulation chunks per step
    "device": None,           # torch device; None = cuda, which must exist
}

# campaign-grid vocabulary (paper Sect. III-B axes / detection env):
# renames map onto trainer knobs; the rest is carried as provenance in
# the report, not consumed by the local LM trainer.
GRID_ALIASES = {"batch_size": "batch"}
GRID_METADATA = ("init", "dataset", "model", "config")

# the reference's kernel-backend names and the port's own
BACKEND_NAMES = {"jnp": "torch", "pallas": "cuda",
                 "torch": "torch", "cuda": "cuda", "auto": "auto"}


def port_backend(name):
    """A backend knob in the port's vocabulary (``None`` stays ``None``:
    the config's default); an unknown name raises."""
    if name is None:
        return None
    if name not in BACKEND_NAMES:
        raise ValueError(f"unknown kernel backend {name!r}; known: "
                         f"{sorted(BACKEND_NAMES)}")
    return BACKEND_NAMES[name]


@register_runner("train")
def run_train(spec: RunSpec) -> RunReport:
    overrides = dict(spec.overrides)
    grid_meta = {k: overrides.pop(k) for k in GRID_METADATA
                 if k in overrides}
    for grid_key, knob in GRID_ALIASES.items():
        if grid_key in overrides:
            overrides[knob] = overrides.pop(grid_key)
    o = spec.replace(overrides=overrides).merged_overrides(DEFAULTS)
    if (int(o["world_size"] or 1) > 1 or o["dist_rank"] is not None
            or o["coordinator"]):
        raise NotImplementedError("data-parallel training (world_size > 1, "
                                  "dist_rank, coordinator) is not ported "
                                  "yet")
    from repro_torch.launch.train import train_main
    t0 = time.time()
    result = train_main(
        spec.arch, reduced=not o["full"], steps=int(o["steps"]),
        batch=int(o["batch"]), seq=int(o["seq"]), lr=float(o["lr"]),
        optimizer=o["optimizer"], seed=spec.seed,
        checkpoint_dir=o["checkpoint_dir"],
        checkpoint_every=int(o["checkpoint_every"]),
        checkpoint_keep=int(o["checkpoint_keep"]),
        checkpoint_async=bool(o["checkpoint_async"]),
        resume=bool(o["resume"]),
        preempt_at_step=(None if o["preempt_at_step"] is None
                         else int(o["preempt_at_step"])),
        s3_root=o["s3_root"], log_every=int(o["log_every"]),
        precision=str(o["precision"]),
        grad_clip=(None if o["grad_clip"] is None else float(o["grad_clip"])),
        microbatches=int(o["microbatches"]),
        attention_backend=port_backend(o["attention_backend"]),
        mixer_backend=port_backend(o["mixer_backend"]),
        device=o["device"])
    artifacts = []
    if o["checkpoint_dir"]:
        artifacts.append(str(o["checkpoint_dir"]))
    if o["s3_root"]:
        artifacts.append(f"{o['s3_root']}/models/{result['arch']}")
    if grid_meta:
        result = {**result, "grid_params": grid_meta}
    return RunReport(kind="train", name=spec.run_name, metrics=result,
                     wall_s=round(time.time() - t0, 3),
                     artifacts=tuple(artifacts), spec=spec.to_dict())

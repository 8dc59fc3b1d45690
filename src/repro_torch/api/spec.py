"""`RunSpec` — the single typed description of *any* run (the port's
copy of ``repro.api.spec``; a spec written for the reference runs here
unchanged).

Every kind of run (train, serve, dryrun, perfprobe, simulate) shares this
one declarative surface: the same spec round-trips through

* CLI flags            — :meth:`RunSpec.from_args`
                         (``python -m repro_torch.launch run``)
* env-var manifests    — :meth:`RunSpec.to_env` / :meth:`RunSpec.from_env`
                         (the paper's bash-automation interface: a
                         Kubernetes Job passes the experiment definition
                         to the container via environment variables)
* JSON configs         — :meth:`RunSpec.to_json` / :meth:`RunSpec.from_json`
                         (the paper's per-experiment JSON config file)
* grid expansion       — :meth:`RunSpec.from_experiment` /
                         :meth:`RunSpec.to_experiment`
                         (``ExperimentSpec.params`` <-> ``overrides``)

Execution happens through the runner registry
(:mod:`repro_torch.api.registry`): ``run(spec) -> RunReport``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.experiment import ExperimentSpec
from repro_torch.core.jobs import JobSpec, Resources

# Kinds shipped with the repo.  The registry accepts new kinds freely —
# a sixth workload is a ``@register_runner`` entry, not a new entrypoint —
# this tuple just drives CLI help and validation error messages.
KNOWN_KINDS = ("train", "serve", "dryrun", "perfprobe", "simulate")

# Kinds whose runner understands a ``resume`` override (restart from the
# last durable checkpoint).  ``to_job`` gives these a retry-env overlay so
# an orchestrator retry resumes instead of recomputing from step 0.
RESUMABLE_KINDS = ("train",)

# Reserved env keys; override keys are declared in RUN_OVERRIDE_KEYS so
# reconstruction never has to guess which env vars belong to the spec.
_ENV_KIND = "RUN_KIND"
_ENV_NAME = "RUN_NAME"
_ENV_ARCH = "ARCH"
_ENV_SEED = "SEED"
_ENV_OVERRIDE_KEYS = "RUN_OVERRIDE_KEYS"
_ENV_RESOURCES = "RESOURCES"
_ENV_DURATION = "DURATION_H"
_ENV_LABELS = "LABELS"
_RESERVED_ENV = {_ENV_KIND, _ENV_NAME, _ENV_ARCH, _ENV_SEED,
                 _ENV_OVERRIDE_KEYS, _ENV_RESOURCES, _ENV_DURATION,
                 _ENV_LABELS}


def _parse_scalar(text: str) -> Any:
    """str -> typed value: JSON where it parses, raw string otherwise
    (so ``"8"`` -> 8, ``"1e-05"`` -> 1e-05, ``"imagenet"`` -> str)."""
    try:
        return json.loads(text)
    except (ValueError, TypeError):
        return text


def _encode_scalar(value: Any) -> str:
    if isinstance(value, str):
        try:
            json.loads(value)
        except (ValueError, TypeError):
            return value            # unambiguous plain string
        return json.dumps(value)    # would mis-parse ("8", "true"): quote
    return json.dumps(value)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """A fully reproducible description of one run of any kind."""

    kind: str
    arch: str = "stablelm-1.6b"
    name: Optional[str] = None
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    resources: Resources = dataclasses.field(default_factory=Resources)
    seed: int = 0
    # scheduling hints, used when the spec becomes a cluster JobSpec
    duration_h: float = 1.0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.kind or not isinstance(self.kind, str):
            raise ValueError(f"RunSpec.kind must be a non-empty string, "
                             f"got {self.kind!r} (known: {KNOWN_KINDS})")
        bad = _RESERVED_ENV.intersection(k.upper() for k in self.overrides)
        if bad:
            raise ValueError(f"override keys collide with reserved env "
                             f"names: {sorted(bad)}")

    # ----------------------------------------------------------- naming
    @property
    def run_name(self) -> str:
        """Explicit name, or a deterministic one derived from content."""
        if self.name:
            return self.name
        base = f"{self.kind}-{self.arch}".replace("_", "-").replace(".", "p")
        if self.overrides:
            return f"{base}-{self.short_hash()}"
        return base

    def short_hash(self) -> str:
        return hashlib.sha1(self.to_json().encode()).hexdigest()[:8]

    # ------------------------------------------------------------- JSON
    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "arch": self.arch,
            "name": self.name,
            "overrides": dict(self.overrides),
            "resources": dataclasses.asdict(self.resources),
            "seed": self.seed,
            "duration_h": self.duration_h,
            "labels": dict(self.labels),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True,
                          default=str)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunSpec":
        res = d.get("resources", {})
        if isinstance(res, Mapping):
            res = Resources(**res)
        return cls(kind=d["kind"], arch=d.get("arch", "stablelm-1.6b"),
                   name=d.get("name"), overrides=dict(d.get("overrides", {})),
                   resources=res, seed=int(d.get("seed", 0)),
                   duration_h=float(d.get("duration_h", 1.0)),
                   labels=dict(d.get("labels", {})))

    @classmethod
    def from_json(cls, text: str) -> "RunSpec":
        return cls.from_dict(json.loads(text))

    # -------------------------------------------------------------- env
    def to_env(self, *, full: bool = False) -> Dict[str, str]:
        """The paper's bash interface: the spec as container env vars.

        Default form carries kind/arch/seed/name + overrides (what a Job
        manifest shows); ``full=True`` adds resources/duration/labels so
        ``from_env(to_env(full=True))`` reconstructs the spec exactly.
        """
        env = {_ENV_KIND: self.kind, _ENV_ARCH: self.arch,
               _ENV_SEED: str(self.seed)}
        if self.name:
            env[_ENV_NAME] = self.name
        env[_ENV_OVERRIDE_KEYS] = ",".join(sorted(self.overrides))
        for k, v in sorted(self.overrides.items()):
            env[k.upper()] = _encode_scalar(v)
        if full:
            env[_ENV_RESOURCES] = json.dumps(
                dataclasses.asdict(self.resources), sort_keys=True)
            env[_ENV_DURATION] = repr(self.duration_h)
            env[_ENV_LABELS] = json.dumps(self.labels, sort_keys=True)
        return env

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 *, kind: Optional[str] = None) -> "RunSpec":
        """Rebuild a spec from environment variables (``os.environ`` by
        default).  Override keys come from ``RUN_OVERRIDE_KEYS`` when
        present (``to_env`` always writes it).  Without the declaration,
        an explicitly passed mapping is treated as curated — every
        non-reserved uppercase key becomes an override (the hand-written
        bash interface) — while bare ``os.environ`` contributes no
        overrides, so PATH/XLA_FLAGS/... are never swept in."""
        curated = env is not None
        env = dict(os.environ if env is None else env)
        k = kind or env.get(_ENV_KIND)
        if not k:
            raise ValueError(f"no {_ENV_KIND} in environment and no "
                             f"kind= given (known kinds: {KNOWN_KINDS})")
        resources = Resources()
        if _ENV_RESOURCES in env:
            resources = Resources(**json.loads(env[_ENV_RESOURCES]))
        if _ENV_OVERRIDE_KEYS in env:
            declared = [key for key in
                        env[_ENV_OVERRIDE_KEYS].split(",") if key]
            missing = [key for key in declared if key.upper() not in env]
            if missing:
                raise ValueError(f"{_ENV_OVERRIDE_KEYS} declares "
                                 f"{missing} but the env vars are not set")
            overrides = {key: _parse_scalar(env[key.upper()])
                         for key in declared}
        elif curated:
            overrides = {key.lower(): _parse_scalar(val)
                         for key, val in env.items()
                         if key not in _RESERVED_ENV and key.isupper()}
        else:
            overrides = {}
        return cls(kind=k, arch=env.get(_ENV_ARCH, "stablelm-1.6b"),
                   name=env.get(_ENV_NAME), overrides=overrides,
                   resources=resources,
                   seed=int(env.get(_ENV_SEED, 0)),
                   duration_h=float(env.get(_ENV_DURATION, 1.0)),
                   labels=json.loads(env.get(_ENV_LABELS, "{}")))

    # -------------------------------------------------------------- CLI
    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "RunSpec":
        """Build a spec from CLI tokens: ``<kind> [--arch A] [--seed N]
        [--name NAME] [--key value | --key=value | --flag] ...``.

        Unknown ``--key`` flags become overrides (dashes -> underscores,
        values JSON-parsed), so every runner knob is reachable without a
        per-kind argparse schema.
        """
        ap = argparse.ArgumentParser(
            prog="python -m repro_torch.launch run", add_help=False,
            description="unified run dispatcher")
        ap.add_argument("kind")
        ap.add_argument("--arch",
                        default=os.environ.get(_ENV_ARCH, "stablelm-1.6b"))
        ap.add_argument("--seed", type=int,
                        default=int(os.environ.get(_ENV_SEED, 0)))
        ap.add_argument("--name", default=None)
        ns, extra = ap.parse_known_args(list(argv))
        return cls(kind=ns.kind, arch=ns.arch, seed=ns.seed, name=ns.name,
                   overrides=_parse_extra_flags(extra))

    # ------------------------------------------------- experiment grids
    @classmethod
    def from_experiment(cls, spec: ExperimentSpec, *, kind: str = "train",
                        arch: str = "stablelm-1.6b",
                        resources: Optional[Resources] = None,
                        seed: int = 0, duration_h: float = 1.0,
                        labels: Optional[Dict[str, str]] = None) -> "RunSpec":
        """An :class:`ExperimentSpec` (one grid point) as a RunSpec:
        ``params`` become ``overrides``, the grid name is kept.  Params
        named after core spec fields (``arch``, ``seed``) land on those
        fields instead of in overrides."""
        params = dict(spec.params)
        arch = str(params.pop("arch", arch))
        seed = int(params.pop("seed", seed))
        return cls(kind=kind, arch=arch, name=spec.name, overrides=params,
                   resources=resources or Resources(), seed=seed,
                   duration_h=duration_h, labels=dict(labels or {}))

    def to_experiment(self) -> ExperimentSpec:
        return ExperimentSpec(self.run_name, dict(self.overrides))

    # ------------------------------------------------------ cluster job
    def to_job(self, payload=None) -> JobSpec:
        """The spec as a schedulable cluster job (manifest env in the
        paper's uppercase bash style).  Resumable kinds additionally get
        a ``retry_env`` — the same spec with ``resume=True`` — so an
        orchestrator retry continues from the last checkpoint instead of
        restarting."""
        retry_env: Dict[str, str] = {}
        if self.kind in RESUMABLE_KINDS and "resume" not in self.overrides:
            retry_env = self.replace(
                overrides={**self.overrides, "resume": True}).to_env()
        # a data-parallel world_size makes the job a gang: all ranks
        # placed atomically by the executor (per-rank `resources`);
        # gang_min opts the gang into elastic shrink on requeue
        gang = max(1, int(self.overrides.get("world_size") or 1))
        return JobSpec(name=self.run_name, payload=payload,
                       env=self.to_env(), retry_env=retry_env,
                       resources=self.resources,
                       priority=int(self.labels.get("priority", 0)),
                       gang=gang,
                       gang_min=int(self.overrides.get("gang_min") or 0),
                       duration_h=self.duration_h, labels=dict(self.labels))

    # ---------------------------------------------------------- helpers
    def merged_overrides(self, defaults: Mapping[str, Any]) -> Dict[str, Any]:
        """defaults <- overrides, rejecting unknown keys (typo guard)."""
        unknown = sorted(set(self.overrides) - set(defaults))
        if unknown:
            raise ValueError(
                f"unknown overrides for kind {self.kind!r}: {unknown}; "
                f"accepted: {sorted(defaults)}")
        return {**defaults, **self.overrides}

    def replace(self, **changes) -> "RunSpec":
        return dataclasses.replace(self, **changes)


def _parse_extra_flags(tokens: Sequence[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected argument {tok!r} "
                             f"(overrides are --key value / --key=value)")
        if "=" in tok:
            key, val = tok[2:].split("=", 1)
            i += 1
        elif i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
            key, val = tok[2:], tokens[i + 1]
            i += 2
        else:                       # bare flag -> boolean override
            key, val = tok[2:], "true"
            i += 1
        out[key.replace("-", "_")] = _parse_scalar(val)
    return out


def grid_to_runs(grid, *, kind: str = "train", arch: str = "stablelm-1.6b",
                 resources: Optional[Resources] = None, seed: int = 0,
                 duration_h: float = 1.0,
                 labels: Optional[Dict[str, str]] = None) -> List[RunSpec]:
    """Expand an :class:`~repro_torch.core.experiment.ExperimentGrid` straight
    into RunSpecs (the implementation behind ``ExperimentGrid.to_runs``)."""
    return [RunSpec.from_experiment(s, kind=kind, arch=arch,
                                    resources=resources, seed=seed,
                                    duration_h=duration_h, labels=labels)
            for s in grid.expand()]

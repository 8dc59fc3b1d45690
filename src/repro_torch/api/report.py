"""`RunReport` — the single typed result of *any* run (the port's copy of
``repro.api.report``).

Every runner produces one; the orchestrator serializes it uniformly to
the PVC / S3 stores.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional, Tuple

SUCCEEDED = "succeeded"
FAILED = "failed"
SKIPPED = "skipped"
_STATUSES = (SUCCEEDED, FAILED, SKIPPED)


@dataclasses.dataclass(frozen=True)
class RunReport:
    kind: str
    name: str
    status: str = SUCCEEDED
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    artifacts: Tuple[str, ...] = ()
    error: Optional[str] = None
    spec: Optional[Dict[str, Any]] = None    # RunSpec.to_dict() provenance

    def __post_init__(self):
        if self.status not in _STATUSES:
            raise ValueError(f"status must be one of {_STATUSES}, "
                             f"got {self.status!r}")
        # artifacts arrive as lists from runners / JSON; normalize
        object.__setattr__(self, "artifacts", tuple(self.artifacts))

    @property
    def ok(self) -> bool:
        return self.status != FAILED

    # ------------------------------------------------------------- JSON
    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "name": self.name,
            "status": self.status,
            "metrics": dict(self.metrics),
            "wall_s": self.wall_s,
            "artifacts": list(self.artifacts),
            "error": self.error,
            "spec": self.spec,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True,
                          default=str)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunReport":
        return cls(kind=d["kind"], name=d["name"],
                   status=d.get("status", SUCCEEDED),
                   metrics=dict(d.get("metrics", {})),
                   wall_s=float(d.get("wall_s", 0.0)),
                   artifacts=tuple(d.get("artifacts", ())),
                   error=d.get("error"), spec=d.get("spec"))

    @classmethod
    def from_json(cls, text: str) -> "RunReport":
        return cls.from_dict(json.loads(text))

    def replace(self, **changes) -> "RunReport":
        return dataclasses.replace(self, **changes)

    # ---------------------------------------------------------- summary
    def summary(self) -> str:
        head = f"[{self.kind}] {self.name}: {self.status}"
        if self.error:
            return f"{head} ({self.error})"
        keys = list(self.metrics)[:4]
        tail = " ".join(f"{k}={self.metrics[k]}" for k in keys)
        return f"{head} wall_s={self.wall_s:.2f} {tail}".rstrip()

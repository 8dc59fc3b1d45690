"""Experiment grids (the port's copy of ``repro.core.experiment``).

The paper's burned-area study expands {3 learning rates} x {3 batch sizes}
x {2 inits} x {2 optimizers} x {2 datasets} = 72 experiments x 2
architectures = 144 trained models, each with an auto-generated JSON
config and two auto-generated YAML manifests (train + eval), 288 total.
:class:`ExperimentGrid` is that expansion, architecture- and
domain-agnostic.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    name: str
    params: Dict[str, Any]

    def config_json(self) -> str:
        """The per-experiment JSON config file (paper: 'a JSON configuration
        file where the specifics of each experiment are defined')."""
        return json.dumps({"experiment": self.name, **self.params},
                          indent=2, sort_keys=True, default=str)

    def short_hash(self) -> str:
        return hashlib.sha1(self.config_json().encode()).hexdigest()[:8]


class ExperimentGrid:
    """Cartesian product over named parameter axes, with optional filters.

    The expansion is computed once and cached (``__len__`` and repeated
    ``expand()`` calls used to redo the full product each time); treat
    ``axes``/``exclude`` as immutable after construction.
    """

    def __init__(self, prefix: str, axes: Dict[str, Sequence[Any]],
                 exclude=None):
        self.prefix = prefix
        self.axes = {k: list(v) for k, v in axes.items()}
        self.exclude = exclude or (lambda params: False)
        self._expanded: Optional[List[ExperimentSpec]] = None

    def __len__(self) -> int:
        return len(self.expand())

    def size_unfiltered(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= len(v)
        return n

    def expand(self) -> List[ExperimentSpec]:
        """Returns a fresh list (safe to mutate); the expansion itself
        is computed once and cached."""
        if self._expanded is None:
            keys = list(self.axes)
            out = []
            for combo in itertools.product(*(self.axes[k] for k in keys)):
                params = dict(zip(keys, combo))
                if self.exclude(params):
                    continue
                tag = "-".join(f"{k}{_fmt(v)}" for k, v in params.items())
                out.append(ExperimentSpec(f"{self.prefix}-{tag}", params))
            self._expanded = out
        return list(self._expanded)

    def to_runs(self, kind: str = "train", **kwargs):
        """Expand straight into ``repro_torch.api.RunSpec``s (params become
        overrides); kwargs: arch, resources, seed, duration_h, labels."""
        from repro_torch.api.spec import grid_to_runs  # lazy: api imports core
        return grid_to_runs(self, kind=kind, **kwargs)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:g}".replace("-", "m").replace(".", "p")
    return str(v).replace("_", "").replace("/", "-").lower()


def paper_burned_area_grid() -> Dict[str, ExperimentGrid]:
    """The paper's exact hyperparameter search (Sect. III-B): 72 experiments
    per architecture x 2 architectures = 144 models."""
    axes = {
        "lr": [1e-3, 1e-4, 1e-5],
        "batch_size": [8, 16, 32],
        "init": ["imagenet", "random"],
        "optimizer": ["adam", "lamb"],
        "dataset": ["norm_rgb", "tci"],
    }
    return {
        arch: ExperimentGrid(f"ba-{arch}", axes)
        for arch in ("unet", "deeplabv3")
    }

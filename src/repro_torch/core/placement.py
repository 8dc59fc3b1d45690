"""Pluggable placement policies for the executor pool and cluster sim
(the port's copy of ``repro.core.placement``).

The paper packs 234 heterogeneous models onto Nautilus's mixed fleet
(GTX-1080 11 GB through A100 80 GB); *where* each job lands decides how
much of that fleet is usable for the next one.  Both placement surfaces
— the campaign executor's resource pool (real campaigns; not ported
yet) and :class:`repro_torch.core.scheduler.ClusterSim` (planning) —
consult one of these policies, selected by the same name end-to-end
(``simulate`` knobs, and ``campaign run --placement`` once the executor
is ported), so a policy evaluated in the sim is the policy the campaign
runs.

A policy ranks *candidate* nodes (already filtered to fit the request);
it never sees unfittable nodes and cannot oversubscribe — capacity
accounting stays in the pool/sim, so every policy inherits the
never-oversubscribe invariant.

Candidates are duck-typed: anything with ``spec`` (a
:class:`repro_torch.core.scheduler.NodeSpec`), ``gpus_free``, ``cpus_free``
and ``mem_free`` — which is exactly the sim's ``_Node`` (and the
reference executor's ``_FreeNode``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

from repro_torch.core.jobs import Resources


class PlacementPolicy:
    """Orders candidate nodes for one resource request; lowest key wins.

    Subclasses implement :meth:`key`.  ``order`` is a stable sort, so
    inventory order breaks remaining ties deterministically.
    """

    name = "base"

    def key(self, node, res: Resources) -> Tuple:
        raise NotImplementedError

    def order(self, cands: Sequence, res: Resources) -> List:
        return sorted(cands, key=lambda n: self.key(n, res))


def _cpu_frac_left(node, res: Resources) -> float:
    return (node.cpus_free - res.cpus) / max(1, node.spec.cpus)


def _mem_frac_left(node, res: Resources) -> float:
    return (node.mem_free - res.memory_gb) / max(1e-9, node.spec.memory_gb)


class BestFit(PlacementPolicy):
    """Smallest sufficient GPU memory, then fewest free devices — the
    historical hard-coded rule: small jobs shouldn't hog A100s."""

    name = "best_fit"

    def key(self, node, res: Resources) -> Tuple:
        return (node.spec.gpu_memory_gb, node.gpus_free)


class WorstFit(PlacementPolicy):
    """Most leftover capacity after placement: spreads load across the
    fleet (keeps every node's headroom for growth), at the cost of
    fragmenting large slots."""

    name = "worst_fit"

    def key(self, node, res: Resources) -> Tuple:
        return (-(node.gpus_free - res.gpus),
                -_cpu_frac_left(node, res),
                -_mem_frac_left(node, res),
                node.spec.gpu_memory_gb)


class Pack(PlacementPolicy):
    """Fragmentation-scored bin packing: place where the *leftover*
    after placement is smallest — first unusable GPU stubs, then
    stranded CPU/memory fractions — preferring the cheapest VRAM class
    among equal fits.  Unlike ``best_fit`` it scores the actual free
    capacity being consumed, not just the VRAM class, so it keeps whole
    nodes open for the big requests still queued."""

    name = "pack"

    def key(self, node, res: Resources) -> Tuple:
        return (node.gpus_free - res.gpus,
                _cpu_frac_left(node, res),
                _mem_frac_left(node, res),
                node.spec.gpu_memory_gb)


PLACEMENT_POLICIES: Dict[str, type] = {
    cls.name: cls for cls in (BestFit, WorstFit, Pack)
}


def get_placement_policy(
        policy: Union[str, PlacementPolicy, None]) -> PlacementPolicy:
    """Resolve a policy by name (the CLI/runner path) or pass an
    instance through (the library path).  ``None`` means the default
    ``best_fit``."""
    if policy is None:
        return BestFit()
    if isinstance(policy, PlacementPolicy):
        return policy
    cls = PLACEMENT_POLICIES.get(str(policy))
    if cls is None:
        raise ValueError(
            f"unknown placement policy {policy!r} "
            f"(expected one of {sorted(PLACEMENT_POLICIES)})")
    return cls()


def gang_rank_capacity(node, res: Resources, cap: int) -> int:
    """How many identical ``res`` ranks this node can host at its
    current free capacity, clamped to ``cap`` (the gang size still
    unplaced).  VRAM is a per-device property, so one rank fitting
    implies any count does on the device axis."""
    if not res.fits(node.gpus_free, node.cpus_free, node.mem_free,
                    node.spec.gpu_memory_gb):
        return 0
    n = cap
    if res.gpus > 0:
        n = min(n, node.gpus_free // res.gpus)
    if res.cpus > 0:
        n = min(n, node.cpus_free // res.cpus)
    if res.memory_gb > 0:
        n = min(n, int(node.mem_free / res.memory_gb + 1e-9))
    return max(0, n)

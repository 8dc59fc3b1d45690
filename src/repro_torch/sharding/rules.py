"""Parameter sharding rules (the port's copy of ``repro.sharding.rules``).

Three layouts:

* ``dp``      — every parameter replicated, only the batch is sharded.
* ``fsdp_tp`` — parameters sharded over the ``data`` axis (FSDP/ZeRO-3
                style) *and* tensor/expert-parallel over the ``model``
                axis; the ``pod`` axis (when present) is pure data
                parallelism, parameters replicated across pods.
* ``fsdp_sp`` — ``fsdp_tp`` with the attention and SSM projections
                sharded over both mesh axes instead of the model axis
                (sequence-parallel activations).

The tables, their regexes and their order are the reference's.  What
differs is what they are applied to:

* A mesh is an axis-size dict, ``{"data": 16, "model": 16}``, as
  :func:`repro_torch.launch.mesh.production_dims` gives it; no device is
  touched.  A spec is a tuple with one entry per dim: ``None``, an axis
  name or a tuple of axis names (the reference's ``PartitionSpec``
  entries).
* The port's layer stack is a list, ``params["layers"][p*P + j]``
  (:mod:`repro_torch.convert`), where the reference stacks
  ``periods/slot{j}/...`` leaves with a leading period dim that its rules
  always leave ``None``.  A port leaf's path is ``layers/{i}/...``: it
  ends in the reference's names, so the ``$``-anchored patterns match it,
  and its spec is the reference's without that leading entry.
* Optimizer moments (``m/...``, ``v/...``) shard like their parameters,
  as the reference's ``build_train`` maps the same rules over the
  optimizer state.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]
Mesh = Mapping[str, int]

LAYOUTS = ("dp", "fsdp_tp", "fsdp_sp")

# (regex over "/"-joined path, spec for the *last* ndims axes)
# Axis entries: "fsdp" -> data axis, "tp" -> model axis, None -> replicated.
_FSDP_TP_RULES = [
    (r"embed/w$",        ("tp", "fsdp")),
    (r"head/w$",         ("fsdp", "tp")),
    (r"attn/w[qkv]/w$",  ("fsdp", "tp")),
    (r"attn/wo/w$",      ("tp", "fsdp")),
    (r"(mlp|shared_mlp)/(up|gate)/w$", ("fsdp", "tp")),
    (r"(mlp|shared_mlp)/down/w$",      ("tp", "fsdp")),
    (r"moe/router/w$",   ("fsdp", None)),
    (r"moe/(up|gate)$",  ("tp", "fsdp", None)),
    (r"moe/down$",       ("tp", None, "fsdp")),
    (r"ssm/in_(z|x|B|C|dt)/w$", ("fsdp", "tp")),
    (r"ssm/out/w$",      ("tp", "fsdp")),
    (r"ssm/conv_w$",     (None, "tp")),
    (r"ssm/conv_b$",     ("tp",)),
    (r"ssm/norm_scale$", ("tp",)),
    (r"ssm/(dt_bias|A_log|D)$", (None,)),
    (r"(norm1|norm2|final_norm)/(scale|bias)$", (None,)),
]

# fsdp_sp overrides: with sequence-parallel activations, attention + SSM
# projection weights drop their tensor (model) axis and FSDP over both
# mesh axes instead (same bytes/chip as (fsdp x tp)); dense MLP and
# shared-expert weights keep the base (fsdp, tp) rule.
_FSDP_SP_OVERRIDES = [
    (r"attn/w[qkv]/w$",  ("fsdp2", None)),
    (r"attn/wo/w$",      ("fsdp2", None)),
    (r"ssm/in_(z|x|B|C|dt)/w$", ("fsdp2", None)),
    (r"ssm/out/w$",      ("fsdp2", None)),
    (r"ssm/conv_w$",     (None, "fsdp2")),
    (r"ssm/conv_b$",     ("fsdp2",)),
    (r"ssm/norm_scale$", ("fsdp2",)),
]


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists (dict keys in
    sorted order, as :func:`repro_torch.tree.tree_map`); a list index is a
    path segment."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_with_path(fn, t, f"{prefix}{i}/")
                for i, t in enumerate(tree)]
    return fn(prefix[:-1], tree)


def axis_extent(mesh: Mesh, axis: AxisVal) -> int:
    """The number of shards an entry makes: the product of its axes'
    sizes (1 for ``None``)."""
    if axis is None:
        return 1
    names = (axis,) if isinstance(axis, str) else axis
    return math.prod(mesh[n] for n in names)


def _resolve(mesh: Mesh, shape, spec_tail, axis_map) -> Spec:
    """Build a spec, dropping axes that don't divide."""
    tail = list(spec_tail)
    # leading dims not covered by the rule
    entries = [None] * (len(shape) - len(tail)) + tail
    out = []
    for dim, ent in zip(shape, entries):
        name = axis_map.get(ent) if ent else None
        if name is not None and dim % axis_extent(mesh, name):
            name = None
        out.append(name)
    return tuple(out)


def _axis_map(mesh: Mesh, layout: str) -> Dict[str, AxisVal]:
    have = set(mesh)
    if layout == "dp":
        return {}
    if layout not in ("fsdp_tp", "fsdp_sp"):
        raise ValueError(layout)
    axis_map = {"fsdp": "data" if "data" in have else None,
                "tp": "model" if "model" in have else None}
    # fsdp2: shard one weight dim over BOTH mesh axes (pure ZeRO-3)
    if "data" in have and "model" in have:
        axis_map["fsdp2"] = ("data", "model")
    elif "data" in have:
        axis_map["fsdp2"] = "data"
    return {k: v for k, v in axis_map.items() if v}


def param_shardings(param_tree, mesh: Mesh, layout: str = "fsdp_tp"):
    """The tree of specs matching ``param_tree`` (tensors of any device,
    meta included; only their shapes are read)."""
    axis_map = _axis_map(mesh, layout)
    rules = _FSDP_TP_RULES
    if layout == "fsdp_sp":
        rules = _FSDP_SP_OVERRIDES + _FSDP_TP_RULES

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        if layout != "dp":
            for pat, tail in rules:
                if re.search(pat, path):
                    return _resolve(mesh, shape, tail, axis_map)
        return (None,) * len(shape)

    return map_with_path(assign, param_tree)


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh)


def logical_axes(mesh: Mesh, layout: str = "fsdp_tp") -> dict:
    """Logical activation axis -> mesh axis mapping for a
    :class:`repro_torch.sharding.ShardCtx`.

    * ``fsdp_tp`` — tensor-parallel activations: d_model ("embed"),
      heads, mlp, experts and vocab over ``model``.
    * ``fsdp_sp`` — sequence-parallel boundaries: the SEQUENCE over
      ``model``; norms, MLPs and routers fully local; experts and vocab
      over ``model``.
    """
    have = set(mesh)
    batch = tuple(a for a in ("pod", "data") if a in have) or None
    if layout == "dp":
        return {"batch": batch}
    model = "model" if "model" in have else None
    if layout == "fsdp_sp":
        return {"batch": batch, "embed": None, "heads": None,
                "kv_heads": None, "mlp": None, "experts": model,
                "vocab": model, "seq": model}
    return {"batch": batch, "embed": model, "heads": model,
            "kv_heads": model, "mlp": model, "experts": model,
            "vocab": model, "seq": None}


def decode_state_shardings(state_tree, mesh: Mesh,
                           layout: str = "fsdp_tp"):
    """Specs for the port's decode state (``{"k", "v"}`` (n_attn, B, L,
    Kh, hd), ``{"h"}`` (n_ssm, B, nh, hp, N), ``{"conv"}`` (n_ssm, B,
    W-1, C)): the batch over (pod, data), the cache sequence of K/V, the
    SSM state's heads and the conv channels over ``model``.  The leading
    dim stacks layers, where the reference's stacks periods: ``None`` in
    both."""
    have = set(mesh)
    batch = tuple(a for a in ("pod", "data") if a in have) or None
    model = "model" if ("model" in have and layout != "dp") else None

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)

        def put(dim, axis):
            if axis is not None and shape[dim] % axis_extent(mesh, axis) == 0:
                # a one-axis tuple is that axis, as a PartitionSpec has it
                spec[dim] = (axis[0] if isinstance(axis, tuple)
                             and len(axis) == 1 else axis)

        name = path.rsplit("/", 1)[-1]
        put(1, batch)
        if name in ("k", "v", "h"):
            put(2, model)
        elif name == "conv":
            put(3, model)
        return tuple(spec)

    return map_with_path(assign, state_tree)


def batch_sharding(mesh: Mesh, ndim: int, batch_dim: int = 0,
                   batch_size: Optional[int] = None) -> Spec:
    """Spec of a data-batch array: the batch dim over (pod, data), or
    over the prefix of those axes that divides ``batch_size`` (batch 1
    is replicated)."""
    axes = batch_axes(mesh)
    if batch_size is not None:
        total = axis_extent(mesh, axes) if axes else 1
        if total and batch_size % total != 0:
            keep, prod = [], 1
            for a in axes:
                if batch_size % (prod * mesh[a]) == 0:
                    keep.append(a)
                    prod *= mesh[a]
            axes = tuple(keep)
    spec = [None] * ndim
    if axes:
        spec[batch_dim] = axes if len(axes) > 1 else axes[0]
    return tuple(spec)


# --------------------------------------------------------------------------
# per-device bytes (the counterpart of the reference's memory_analysis
# argument sizes, from the specs alone)
# --------------------------------------------------------------------------
def shard_shape(shape, spec: Spec, mesh: Mesh) -> tuple:
    """One device's block of an array of ``shape`` under ``spec``."""
    return tuple(d // axis_extent(mesh, a) for d, a in zip(shape, spec))


def per_device_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, meta ones too) under
    ``specs``: each leaf's shard shape times its element size."""
    from repro_torch.tree import tree_leaves
    total = 0
    for t, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        total += (math.prod(shard_shape(t.shape, spec, mesh))
                  * t.element_size())
    return total

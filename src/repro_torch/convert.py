"""Weights across the two packages, in the reference's checkpoint key
scheme (``repro.checkpoint.io._flatten``): a parameter tree flattened to
``"/"``-joined path keys, e.g. ``"periods/slot0/attn/wq/w"``, whose
``periods`` leaves carry a leading (n_periods,) axis.  A period of P
slots (``repro_torch.models.model.period_len``: 1 for the dense and SSM
stacks, 2 for llama4's MoE on every other layer, 8 for jamba) maps
``periods/slot{j}/...`` row p onto ``params["layers"][p*P + j]``.  A
leaf keeps its dtype either way, so the f32 MoE router beside bf16
weights round-trips bitwise.

A bf16 leaf leaves torch as a numpy array of dtype ``V2`` (two raw bytes)
holding its bit pattern: numpy has no bf16 type of its own, and ``V2`` is
what ``np.load`` returns for the reference's bf16 (``ml_dtypes``) leaves,
so both packages' checkpoints restore bitwise without ``ml_dtypes``.

The vision models (``models/segmentation.py``, ``models/changeformer.py``)
have no ``ArchConfig`` and hold lists: the reference's ``_flatten`` names a
list index as a path segment (``"enc/0/c1/w"``,
``"stages/1/blocks/0/qkv/w"``, ``"nodes/0_1/c2/b"``).
:func:`vision_params_from_flat` rebuilds those lists from the integer
segments, and the weights keep the reference's HWIO layout, so the round
trip is bitwise.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import period_len, require_ported

# numpy form of a bf16 leaf: its bit pattern as two raw bytes
BF16_NUMPY = np.dtype("V2")


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def _items(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists; a list index is a
    path segment."""
    pairs = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in pairs:
        if isinstance(val, (dict, list)):
            yield from _items(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _listify(tree):
    """Dicts whose keys are 0..n-1 (as strings) become lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def _to_torch(arr: np.ndarray, device, dtype) -> torch.Tensor:
    arr = np.array(arr, copy=True)         # the params never alias `flat`
    # bf16 as bits (V2), or the reference's in-memory ml_dtypes bf16
    if arr.dtype == BF16_NUMPY or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def slot_prefix(j: int) -> str:
    """The flat-key prefix of period slot ``j``."""
    return f"periods/slot{j}/"


def params_from_flat(flat: Dict[str, np.ndarray], cfg: ArchConfig, *,
                     device=None, dtype: Optional[torch.dtype] = None):
    """Flat reference checkpoint arrays -> the port's params.

    ``dtype`` (optional) casts every floating leaf; by default each leaf
    keeps its dtype.  ``device`` defaults to ``cuda``.
    """
    require_ported(cfg)
    device = resolve_device(device)
    P = period_len(cfg)
    n_periods = cfg.n_layers // P
    params: dict = {"layers": [{} for _ in range(cfg.n_layers)]}
    for key, arr in flat.items():
        if key.startswith("periods/"):
            slot, rest = key[len("periods/"):].split("/", 1)
            j = int(slot[len("slot"):])
            if j >= P or arr.shape[0] != n_periods:
                raise ValueError(f"{key}: slot {j} of a period of {P}, "
                                 f"leading axis {arr.shape[0]} != n_periods "
                                 f"{n_periods}")
            for p in range(n_periods):
                _set(params["layers"][p * P + j], rest,
                     _to_torch(arr[p], device, dtype))
        else:
            _set(params, key, _to_torch(arr, device, dtype))
    return params


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of ``t``); bf16 as :data:`BF16_NUMPY`."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_NUMPY)
    return t.numpy()


def params_to_flat(params, period: int = 1) -> Dict[str, np.ndarray]:
    """The port's params -> flat reference checkpoint arrays (inverse of
    :func:`params_from_flat`).  ``period`` is the config's
    :func:`~repro_torch.models.model.period_len`: layer p·P + j becomes
    row p of ``periods/slot{j}/...``."""
    flat = {}
    for key, t in _items({k: v for k, v in params.items() if k != "layers"}):
        flat[key] = _to_numpy(t)
    layers = params["layers"]
    for j in range(period):
        per_layer = [dict(_items(layer)) for layer in layers[j::period]]
        if any(l.keys() != per_layer[0].keys() for l in per_layer):
            raise ValueError(f"the layers of slot {j} differ in their "
                             f"leaves: not a period of {period}")
        for key in per_layer[0]:
            flat[slot_prefix(j) + key] = np.stack(
                [_to_numpy(l[key]) for l in per_layer])
    return flat


def vision_params_from_flat(flat: Dict[str, np.ndarray], *, device=None,
                            dtype: Optional[torch.dtype] = None):
    """Flat reference arrays of a segmentation model or ChangeFormer -> the
    port's params (nested dicts and lists; weights stay HWIO).  ``device``
    defaults to ``cuda``."""
    device = resolve_device(device)
    params: dict = {}
    for key, arr in flat.items():
        _set(params, key, _to_torch(arr, device, dtype))
    return _listify(params)


def vision_params_to_flat(params) -> Dict[str, np.ndarray]:
    """The port's vision params -> flat reference arrays (inverse of
    :func:`vision_params_from_flat`)."""
    return {key: _to_numpy(t) for key, t in _items(params)}

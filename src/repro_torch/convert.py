"""Weights across the two packages, in the reference's checkpoint key
scheme (``repro.checkpoint.io._flatten``): a parameter tree flattened to
``"/"``-joined path keys, e.g. ``"periods/slot0/attn/wq/w"``, whose
``periods`` leaves carry a leading (n_periods,) axis.  For the dense stack
a period is one layer, so ``periods/slot0/...`` has a leading n_layers axis
and maps onto ``params["layers"][i]``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import _require_dense

_PERIOD = "periods/slot0/"


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def _items(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _items(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _to_torch(arr: np.ndarray, device, dtype) -> torch.Tensor:
    arr = np.array(arr, copy=True)         # the params never alias `flat`
    if arr.dtype.name == "bfloat16":       # ml_dtypes bf16 from the reference
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def params_from_flat(flat: Dict[str, np.ndarray], cfg: ArchConfig, *,
                     device=None, dtype: Optional[torch.dtype] = None):
    """Flat reference checkpoint arrays -> the port's params.

    ``dtype`` (optional) casts every floating leaf; by default each leaf
    keeps its dtype.  ``device`` defaults to ``cuda``.
    """
    _require_dense(cfg)
    device = resolve_device(device)
    params: dict = {"layers": [{} for _ in range(cfg.n_layers)]}
    for key, arr in flat.items():
        if key.startswith(_PERIOD):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} != "
                                 f"n_layers {cfg.n_layers}")
            for i in range(cfg.n_layers):
                _set(params["layers"][i], key[len(_PERIOD):],
                     _to_torch(arr[i], device, dtype))
        elif key.startswith("periods/"):
            raise ValueError(f"{key}: only one slot per period is ported")
        else:
            _set(params, key, _to_torch(arr, device, dtype))
    return params


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_flat(params) -> Dict[str, np.ndarray]:
    """The port's params -> flat reference checkpoint arrays (inverse of
    :func:`params_from_flat`)."""
    flat = {}
    for key, t in _items({k: v for k, v in params.items() if k != "layers"}):
        flat[key] = _to_numpy(t)
    per_layer = [dict(_items(layer)) for layer in params["layers"]]
    for key in per_layer[0]:
        flat[_PERIOD + key] = np.stack([_to_numpy(l[key]) for l in per_layer])
    return flat

"""Weights across the two packages, in the reference's checkpoint key
scheme (``repro.checkpoint.io._flatten``): a parameter tree flattened to
``"/"``-joined path keys, e.g. ``"periods/slot0/attn/wq/w"``, whose
``periods`` leaves carry a leading (n_periods,) axis.  For the ported
stacks (dense and SSM) a period is one layer, so ``periods/slot0/...``
(``periods/slot0/attn/wq/w``, ``periods/slot0/ssm/in_z/w``, ...) has a
leading n_layers axis and maps onto ``params["layers"][i]``.

A bf16 leaf leaves torch as a numpy array of dtype ``V2`` (two raw bytes)
holding its bit pattern: numpy has no bf16 type of its own, and ``V2`` is
what ``np.load`` returns for the reference's bf16 (``ml_dtypes``) leaves,
so both packages' checkpoints restore bitwise without ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import require_ported

_PERIOD = "periods/slot0/"
# numpy form of a bf16 leaf: its bit pattern as two raw bytes
BF16_NUMPY = np.dtype("V2")


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
    # bf16 as bits (V2), or the reference's in-memory ml_dtypes bf16
    if arr.dtype == BF16_NUMPY or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
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
    require_ported(cfg)
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
    """A host copy (never a view of ``t``); bf16 as :data:`BF16_NUMPY`."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_NUMPY)
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

"""Production meshes, as axis dicts (the port's copy of
``repro.launch.mesh``).

The reference builds a JAX device mesh: one TPU v5e pod of 16 x 16 = 256
chips, or two pods (``pod`` x ``data`` x ``model`` = 2 x 16 x 16).  The
port touches no device here: :func:`production_dims` returns the same
mesh's axis sizes, which is all the analytic model
(:func:`repro_torch.analysis.analytic.mesh_dims`) reads.
"""
from __future__ import annotations

from typing import Dict


def production_dims(multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as ``{axis: size}``."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_tag(multi_pod: bool = False) -> str:
    """The reference's name for the mesh in its dry-run records."""
    return "2x16x16" if multi_pod else "16x16"


INPUT_SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

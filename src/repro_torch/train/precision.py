"""Mixed-precision policy for the training hot path (port of
``repro.train.precision``).

One :class:`Precision` names the dtype of every role in a train step:

* ``param_dtype``   — master parameters and optimizer state;
* ``compute_dtype`` — forward/backward activation dtype.  The layers'
  parameters are cast to it inside the step (the cast's backward returns
  the gradient in the master dtype);
* ``grad_dtype``    — microbatch gradient-accumulation dtype, f32;
* the loss is always reduced in f32 (``models.model.train_loss`` upcasts
  the logits before logsumexp).
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.models.model import cast_floating  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str = "f32"
    param_dtype: str = "float32"     # master params + optimizer state
    compute_dtype: str = "float32"   # forward/backward activations
    grad_dtype: str = "float32"      # microbatch grad accumulation

    @property
    def casts_compute(self) -> bool:
        return self.compute_dtype != self.param_dtype


POLICIES = {
    "f32": Precision(),
    "bf16": Precision(name="bf16", compute_dtype="bfloat16"),
}


def get_precision(policy: Union[str, Precision, None]) -> Precision:
    """Resolve a policy name (``"f32"``/``"bf16"``), a :class:`Precision`,
    or ``None`` (-> f32) to a :class:`Precision`."""
    if policy is None:
        return POLICIES["f32"]
    if isinstance(policy, Precision):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown precision policy {policy!r}; "
                         f"known: {sorted(POLICIES)}")
    return POLICIES[policy]

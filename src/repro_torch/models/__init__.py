from repro_torch.models.model import (
    decode_and_sample,
    decode_step,
    init_decode_state,
    init_params,
    param_specs,
    prefill,
    prefill_and_sample,
    sample_tokens,
)

__all__ = [
    "init_params", "param_specs", "prefill", "init_decode_state",
    "decode_step", "sample_tokens", "decode_and_sample",
    "prefill_and_sample",
]

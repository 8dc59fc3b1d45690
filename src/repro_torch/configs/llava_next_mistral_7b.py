"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM: the anyres-tiled vision frontend is a stub, as in the reference:
``repro_torch.data.inputs.input_specs`` supplies projected patch
embeddings; this config is the Mistral-7B language decoder that consumes
them.
"""
from repro_torch.configs.base import ArchConfig, register, reduce_config

FULL = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32_000,
    frontend_tokens=1024,  # anyres patch embeddings supplied by the stub
    sliding_window=8192,
    optimizer="adamw",
)

register(FULL, lambda: reduce_config(FULL))

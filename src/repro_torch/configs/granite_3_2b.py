"""Granite-3.0 2B base [hf:ibm-granite/granite-3.0-2b-base] — GQA."""
from repro_torch.configs.base import ArchConfig, register, reduce_config

FULL = ArchConfig(
    name="granite-3-2b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49_155,
    tie_embeddings=True,
    sliding_window=8192,
    optimizer="adamw",
)

register(FULL, lambda: reduce_config(FULL))

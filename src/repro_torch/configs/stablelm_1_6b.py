"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ArchConfig, register, reduce_config

FULL = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100_352,
    norm="layernorm",
    sliding_window=8192,
    optimizer="adamw",
)

register(FULL, lambda: reduce_config(FULL))

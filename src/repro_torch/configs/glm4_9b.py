"""GLM-4 9B [hf:THUDM/glm-4-9b] — RoPE, aggressive GQA (kv=2)."""
from repro_torch.configs.base import ArchConfig, register, reduce_config

FULL = ArchConfig(
    name="glm4-9b",
    family="dense",
    source="hf:THUDM/glm-4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151_552,
    sliding_window=8192,
    optimizer="adamw",
)

register(FULL, lambda: reduce_config(FULL))

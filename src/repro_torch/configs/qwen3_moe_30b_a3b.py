"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts, top-8, head_dim=128."""
from repro_torch.configs.base import (ArchConfig, MoEConfig, register,
                                      reduce_config)

FULL = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=0,                # all layers are MoE (no dense MLP layers)
    vocab=151_936,
    d_head=128,            # explicit head_dim (> d_model // n_heads)
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=768, every=1),
    sliding_window=8192,
    optimizer="adamw",
)

register(FULL, lambda: reduce_config(FULL))

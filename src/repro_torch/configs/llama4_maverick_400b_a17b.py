"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

MoE with 128 routed experts, top-1 routing, one shared expert, MoE layers
interleaved every 2nd layer (matching the A17B active budget), early-fusion
multimodal lineage (text path modeled here).
"""
from repro_torch.configs.base import (ArchConfig, MoEConfig, register,
                                      reduce_config)

FULL = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,            # dense-layer MLP + shared expert ff
    vocab=202_048,
    moe=MoEConfig(n_experts=128, top_k=1, expert_d_ff=8192, every=2,
                  shared_expert=True),
    sliding_window=8192,   # used by the long_500k decode variant
    # SGD+momentum: the paper's own default optimizer for most models, and
    # the 400B-class memory budget (1 moment, not 2) — see DESIGN.md §5.
    optimizer="sgdm",
)

register(FULL, lambda: reduce_config(FULL))

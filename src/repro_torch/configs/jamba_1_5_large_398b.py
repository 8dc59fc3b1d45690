"""Jamba-1.5-Large 398B [arXiv:2403.19887].

Hybrid Mamba+attention, 1:7 attn:mamba interleave, MoE 16 experts top-2 on
every other layer.
"""
from repro_torch.configs.base import (ArchConfig, MoEConfig, SSMConfig,
                                      register, reduce_config)

FULL = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65_536,
    moe=MoEConfig(n_experts=16, top_k=2, expert_d_ff=24576, every=2),
    ssm=SSMConfig(d_state=128, head_dim=128, n_groups=8, chunk=256, expand=2),
    attn_every=8,          # 1 attention layer per 8 => 1:7 interleave
    optimizer="sgdm",      # 398B-class memory budget (see DESIGN.md §5)
)

register(FULL, lambda: reduce_config(FULL))

"""Mamba2-2.7B [arXiv:2405.21060] — SSD (state-space duality), attention-free."""
from repro_torch.configs.base import (ArchConfig, SSMConfig, register,
                                      reduce_config)

FULL = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=0,                # Mamba2 blocks have no separate MLP
    vocab=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, chunk=256, expand=2),
    tie_embeddings=True,
    optimizer="adamw",
)

register(FULL, lambda: reduce_config(FULL))

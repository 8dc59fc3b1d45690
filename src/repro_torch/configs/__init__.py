from repro_torch.configs.base import (
    ArchConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    get_reduced,
    list_archs,
    reduce_config,
)

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig",
    "get_config", "get_reduced", "list_archs", "reduce_config",
]

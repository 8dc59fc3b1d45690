from repro_torch.kernels.percentile_norm.ops import percentile_normalize

__all__ = ["percentile_normalize"]

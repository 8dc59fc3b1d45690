from repro_torch.analysis.analytic import (MeshDims, analytic_roofline,
                                           mesh_dims)
from repro_torch.analysis.profile import device_profile
from repro_torch.analysis.roofline import HW, Hardware, model_flops, \
    profile_terms

__all__ = ["MeshDims", "mesh_dims", "analytic_roofline", "device_profile",
           "HW", "Hardware", "model_flops", "profile_terms"]

"""Data sources of the port: copies of the reference's numpy-only token
stream, its model inputs for every family (the vlm and audio
frontends are stubs that feed seeded patch and frame embeddings), and its
raster, chipping and normalization pipeline, and the chip loader with a
prefetch onto the device."""
from repro_torch.data.inputs import (SeekableSyntheticBatches, decode_specs,
                                     input_specs, make_batch,
                                     make_decode_batch)

__all__ = ["input_specs", "make_batch", "decode_specs",
           "SeekableSyntheticBatches", "make_decode_batch"]

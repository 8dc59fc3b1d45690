"""Data sources of the port: copies of the reference's numpy-only token
stream and its raster, chipping and normalization pipeline, and the chip
loader with a prefetch onto the device."""

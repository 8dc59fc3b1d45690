"""PyTorch and CUDA port of the ``repro`` package for an NVIDIA H100.

The JAX package ``repro`` stays the reference; module names here mirror
it.  This package imports neither JAX nor anything of ``repro``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

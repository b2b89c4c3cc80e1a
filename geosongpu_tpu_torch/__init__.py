"""PyTorch/CUDA port of the geosongpu_tpu dynamical core.

The JAX package `geosongpu_tpu` is the reference; this package computes
the same functions in PyTorch on the same `[face, y, x, K]` layout, and
replaces each Pallas kernel of its path with a CUDA kernel written for
Hopper (`csrc/`).  It never imports jax.
"""

"""The benchmark's plain reference: a frozen copy of the port's eager
Held-Suarez step (no hand-written kernel, no fused path), in plain PyTorch.

It imports neither jax nor anything of geosongpu_tpu or geosongpu_tpu_torch,
and builds its own grid, metrics and static context from the configuration
it is given.  Each module names the file and commit it was copied from, so
that an edit to the program cannot move the yardstick unseen.
"""

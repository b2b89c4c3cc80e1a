"""The CI harness of the port: experiments by name, dispatched to tasks
that run a model of the port and check its results (the jax-free base of
geosongpu_tpu/harness, copied, and the port's own tasks)."""

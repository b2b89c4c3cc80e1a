"""The port's hand-written CUDA kernels: each module holds wrappers, each
wrapper a `launches` counter that grows by one where it launches its
kernel."""


def launch_counts() -> dict:
    """{kernel name: launches so far} over every kernel wrapper."""
    from . import columns, dsw, microphysics, remap, standalone_twins

    wrappers = ((remap.remap_banded,) + dsw.KERNELS
                + (microphysics.gfdl_microphysics,) + columns.KERNELS
                + standalone_twins.KERNELS)
    return {k.__name__: k.launches for k in wrappers}

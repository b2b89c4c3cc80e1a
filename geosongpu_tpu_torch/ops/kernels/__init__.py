"""The port's hand-written CUDA kernels: each module holds wrappers, each
wrapper a `launches` counter that grows by one where it launches its
kernel."""


def _wrappers() -> tuple:
    from . import chart, columns, dsw, microphysics, remap, standalone_twins

    return ((remap.remap_banded,) + dsw.KERNELS
            + (microphysics.gfdl_microphysics,) + columns.KERNELS
            + standalone_twins.KERNELS + chart.KERNELS)


def launch_counts() -> dict:
    """{kernel name: launches so far} over every kernel wrapper."""
    return {k.__name__: k.launches for k in _wrappers()}


def reset_launch_counts() -> None:
    """Set every wrapper's count to 0."""
    for k in _wrappers():
        k.launches = 0

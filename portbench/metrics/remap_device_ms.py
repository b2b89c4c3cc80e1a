"""Device ms per step of the banded remap (remap_banded_kernel)."""
from portbench.devtrace import wrapper_times


def read(rec):
    us = wrapper_times(rec.events).get("remap_banded", 0.0)
    return us / 1e3 / rec.steps if us else None

"""Device ms per step of the nonhydrostatic vertical solve
(nh_vertical_columns); nothing where the step runs none."""
from portbench.devtrace import wrapper_times


def read(rec):
    us = wrapper_times(rec.events).get("nh_vertical_solve", 0.0)
    return us / 1e3 / rec.steps if us else None

"""nh_vertical_solve's share of its roofline: its counted calls' least
time (portbench/counts.py) over its device time; nothing where the step
runs no such launch."""
from portbench.counts import calls_bound_s
from portbench.devtrace import wrapper_times


def read(rec):
    us = wrapper_times(rec.events).get("nh_vertical_solve", 0.0)
    if not us:
        return None
    bound = calls_bound_s([k for k in rec.calls
                           if k.wrapper == "nh_vertical_solve"], rec.peaks)
    return 100.0 * bound / (us / 1e6 / rec.steps)

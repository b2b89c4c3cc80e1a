"""The dsw_* launches' share of their roofline: the sum of each counted
call's least time (portbench/counts.py) over their device time, both
taken over the wrappers the trace shows."""
from portbench.counts import calls_bound_s
from portbench.devtrace import wrapper_times


def read(rec):
    times = {w: t for w, t in wrapper_times(rec.events).items()
             if w.startswith("dsw_")}
    if not times:
        return None
    bound = calls_bound_s([k for k in rec.calls if k.wrapper in times],
                          rec.peaks)
    return 100.0 * bound / (sum(times.values()) / 1e6 / rec.steps)

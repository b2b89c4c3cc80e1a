"""The aquaplanet chain's column kernels' share of their roofline: the sum
of each counted call's least time (portbench/counts.py `calls_bound_s` of
the calls portbench/models/aquaplanet_columns.py counts) over their device
time, both taken over the kernels the trace shows."""
from portbench.counts import calls_bound_s
from portbench.models.aquaplanet_columns import device_us


def read(rec):
    times = device_us(rec.events)
    if not times or rec.peaks is None:
        return None
    bound = calls_bound_s([k for k in rec.calls if k.wrapper in times],
                          rec.peaks)
    return 100.0 * bound / (sum(times.values()) / 1e6 / rec.steps)

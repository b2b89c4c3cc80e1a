"""The whole step's share of the card's peak: the step's least time (the
larger of its counted bytes over the memory rate and its counted
operations over the float32 rate, portbench/counts.py) over the measured
wall time per step of the untraced window.  The count leaves the glue
out, so the share cannot pass 100%."""
from portbench.counts import bound_s


def read(rec):
    if rec.wall_s_per_step <= 0.0 or rec.peaks is None:
        return None
    return 100.0 * bound_s(rec.calls, rec.peaks) / rec.wall_s_per_step

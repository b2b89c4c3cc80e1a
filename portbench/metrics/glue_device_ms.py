"""Device ms per step of the device events that are none of the port's
kernel stages: the plain PyTorch glue between the kernels (fills, chart
corners, A-grid winds, refills, forcing, symmetrization), copies and
sets included."""
from portbench.devtrace import stage_of


def read(rec):
    if not rec.events:
        return None
    us = sum(e.dur for e in rec.events
             if e.cat != "kernel" or stage_of(e.name) is None)
    return us / 1e3 / rec.steps

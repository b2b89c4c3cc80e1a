"""Device ms a step of the events launched inside `physics` spans, their
children's included: the aquaplanet chain's three column kernels and the
plain PyTorch around them (the Exner function, the surface fluxes, the
tracer re-stack and the relaxation) (portbench/spans.py); nothing where
the spans do not line up with the trace (span_launch_match under 0.99)
or no step holds a `physics` span."""
from portbench import spans


def read(rec):
    a = spans.analyse(rec)
    if not spans.layer_metrics(a):
        return None
    return a["by_span"].get("physics", {}).get("device_ms")

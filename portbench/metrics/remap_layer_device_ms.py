"""Device ms a step of the events launched inside `remap` spans: the
banded remap kernels and the remap's geometry glue (portbench/spans.py);
nothing where the spans do not line up with the trace (span_launch_match
under 0.99)."""
from portbench import spans


def read(rec):
    return spans.layer_metrics(spans.analyse(rec)).get("remap_layer_device_ms")

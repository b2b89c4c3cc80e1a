"""Host ms a step inside `kernel.*` spans: the hand kernels' wrappers,
their checks and launches (portbench/spans.py); nothing where the spans do
not line up with the trace (span_launch_match under 0.99)."""
from portbench import spans


def read(rec):
    return spans.layer_metrics(spans.analyse(rec)).get("wrapper_host_ms")

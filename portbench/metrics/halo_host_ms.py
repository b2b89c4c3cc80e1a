"""Host ms a step inside `halo.*` and `exchange.*` spans, less the
`kernel.*` spans inside them (portbench/spans.py); nothing where the spans
do not line up with the trace (span_launch_match under 0.99)."""
from portbench import spans


def read(rec):
    return spans.layer_metrics(spans.analyse(rec)).get("halo_host_ms")

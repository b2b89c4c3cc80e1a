"""Host ms a step inside `step` spans but in no `kernel.*`, `halo.*` or
`exchange.*` span: the dispatch of the plain PyTorch glue, and the waits
on a full launch queue (portbench/spans.py); nothing where the spans do
not line up with the trace (span_launch_match under 0.99)."""
from portbench import spans


def read(rec):
    return spans.layer_metrics(spans.analyse(rec)).get("glue_host_ms")

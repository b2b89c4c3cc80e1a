"""Device ms a step of the events launched inside a `halo.*` or
`exchange.*` span: the halo fills, the shared-edge symmetrization and the
exchange (portbench/spans.py); nothing where the spans do not line up with
the trace (span_launch_match under 0.99)."""
from portbench import spans


def read(rec):
    return spans.layer_metrics(spans.analyse(rec)).get("halo_device_ms")

"""Trace one cell of the benchmark with the program's spans recorded.

    python3 portbench/span_trace.py --workload <name> --seed <n>
                                    --seconds <s> [--record 0|1]

Steps the cell as `portbench/run.py --trace 1` does (build, warm-up, an
untraced window of `--seconds`, a first profile of three steps that is not
read, then the traffic's `trace_steps` steps under torch.profiler with
device activity alone), with the program's spans recorded around the
build and around the traced steps (`--record 0`: no spans, for what the
recording costs).  Prints one JSON line: the cell's accepted per-layer
metrics read from the same trace, the span metrics
(portbench/spans.py LAYER_METRICS), the step span's host ms against
`host_issue_ms`, and the span breakdown (by_span, idle_by_span,
setup_by_span, span_launch_match).

A measurement, not a benchmark run: it makes no correctness check and
reads no end-to-end metric.  Exits 2 without a CUDA card for the cell.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = _ROOT
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from portbench import run as bench_run  # noqa: E402


@dataclass
class SpanTraceRecord(bench_run.TraceRecord):
    """A TraceRecord with the program's spans on the trace's clock and the
    trace's runtime calls (portbench/spans.py)."""

    spans: list = field(default_factory=list)
    runtime_calls: list = field(default_factory=list)


def span_trace(cell, seed: int, seconds: float, record: bool,
               device: str) -> dict:
    """One traced run of `cell` on `device`: the result line's object.  On
    a CPU device (the tests, at small sizes) the profiler records host
    activity only, so no device event is read and the accepted readers
    are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import counts, devtrace, drive, spans, spec

    cuda = torch.device(device).type == "cuda"
    cfg, traffic = cell.config, cell.traffic

    def spans_on():
        return spans.recording() if record else contextlib.nullcontext([])

    with spans_on() as setup_records:
        model = drive.build_program(cfg, device)
    state = drive.initial_state(model, traffic, seed)
    warm = drive.free_run(model, state, traffic,
                          steps=traffic["warmup_steps"])
    win = drive.free_run(model, warm.state, traffic, seconds=seconds)
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with profile(activities=acts):
        state = drive.free_run(model, win.state, traffic, steps=3).state
    with tempfile.TemporaryDirectory(prefix="portbench_spans_") as tmp:
        with profile(activities=acts) as prof:
            with spans_on() as records:
                drive.free_run(model, state, traffic,
                               steps=traffic["trace_steps"])
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        events = devtrace.read_trace(path)
        base_ns, calls = spans.read_calls(path, events)
    if cuda:
        torch.cuda.synchronize(device)

    b = devtrace.busy(events)
    rec = SpanTraceRecord(
        events=events, steps=traffic["trace_steps"], busy_s=b["busy_s"],
        window_s=b["span_s"], calls=counts.step_calls(cfg["dycore"]),
        peaks=counts.PEAKS.get(torch.cuda.get_device_name(device))
        if cuda else None,
        wall_s_per_step=win.window_s / win.steps, issue_s=win.issue_s,
        spans=spans.on_trace_clock(records, base_ns), runtime_calls=calls)
    a = spans.analyse(rec)
    out = {"workload": cell.name, "seed": seed, "record": int(record),
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "busy_ms_per_step": 1e3 * b["busy_s"] / rec.steps,
           "window_ms_per_step": 1e3 * b["span_s"] / rec.steps,
           "metrics": spec.read_metrics(cell.per_layer, "metrics", rec,
                                        cell.root) if cuda else {},
           "span_metrics": spans.layer_metrics(a)}
    issue_ms = 1e3 * sum(win.issue_s) / len(win.issue_s)
    step = (a or {}).get("by_span", {}).get("step")
    if step:
        out["step_span_ms"] = step["host_ms"]
        out["step_vs_issue_pct"] = 100.0 * (step["host_ms"] / issue_ms - 1)
    out["breakdown"] = spans.breakdown(a, setup_records)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/span_trace.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s)", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = span_trace(cell, args.seed, args.seconds, bool(args.record),
                        "cuda:0")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

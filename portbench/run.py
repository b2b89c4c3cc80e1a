"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Builds the cell's model through the program's own entry, draws the
initial state from the seed, warms up with the traffic's steps (set-up
ends there), then steps free-running for `--seconds` seconds with tracing
off and reads the end-to-end metrics.  With `--trace 1` it then traces the
traffic's `trace_steps` further steps with torch.profiler, with the
program's spans recorded around them and around the build
(portbench/spans.py), and reports the per-layer metrics instead, with the
spans' breakdown (`by_span`, `idle_by_span`, `setup_by_span`,
`span_launch_match`) beside the trace's.  Last, once the program's state
is freed, the plain reference (portbench/reference/) checks the initial
state, the first step from it and two window steps drawn from the seed
(portbench/compare.py).  The cell's model file (portbench/models/) builds
both sides.  The last line on standard output is one JSON object:
correct, attempted, failed, metrics, device (and breakdown with `--trace
1`), and last the numbers compared with their limits, which are also the
last lines on standard error.

Exits non-zero, printing no result, without a CUDA card for the cell, or
if jax, jaxlib, flax or the JAX package (geosongpu_tpu, compared by the
whole top-level module name) was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root on the path in place of this script's directory, so
# that `portbench.*` and the program import as packages
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = _ROOT
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# a library the port uses must not load JAX by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "geosongpu_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN (whole
    names: geosongpu_tpu_torch is not geosongpu_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclass
class WindowRecord:
    """What the end-to-end readers read (portbench/end_to_end/)."""

    steps: int
    window_s: float
    intervals_s: list   # between consecutive end stamps; no reader yet
    dt: float
    energy_j: float
    setup_s: float


@dataclass
class TraceRecord:
    """What the per-layer readers read (portbench/metrics/)."""

    events: list
    steps: int
    busy_s: float
    window_s: float
    calls: list
    peaks: dict
    wall_s_per_step: float   # of the untraced window
    issue_s: list            # the untraced window's host time in each step
    # the program's spans of the traced steps on the trace's clock, and the
    # trace's runtime calls (portbench/spans.py)
    spans: list = field(default_factory=list)
    runtime_calls: list = field(default_factory=list)


def trace_steps(model, state, traffic, device):
    """Trace the traffic's trace_steps steps from `state` with the
    profiler's device activity alone, the program's spans recorded around
    them: (device events, spans on the trace's clock, runtime calls, the
    final state).  Host operators are not recorded: on the card-bound c192
    step their cost (~10 us a launch) made the host the bottleneck and the
    traced window 21% idle against 3% without them.  A first profile of
    three steps, not read, starts the device tracing outside the traced
    steps (the first session in a process read up to 1.5 points more
    idle).  On a CPU device (the tests) the profiler records host activity,
    in which no device event is found."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import devtrace, drive, spans

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with profile(activities=acts):
        state = drive.free_run(model, state, traffic, steps=3).state
    with tempfile.TemporaryDirectory(prefix="portbench_trace_") as tmp:
        with profile(activities=acts) as prof:
            with spans.recording() as records:
                win = drive.free_run(model, state, traffic,
                                     steps=traffic["trace_steps"])
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        events = devtrace.read_trace(path)
        base_ns, calls = spans.read_calls(path, events)
    if cuda:
        torch.cuda.synchronize(device)
    return events, spans.on_trace_clock(records, base_ns), calls, win.state


def finite(state, fields) -> bool:
    import torch

    return all(bool(torch.isfinite(getattr(state, f)).all()) for f in fields)


def run(cell, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """One run of `cell` on `device`: the result line's object.  On a CPU
    device (the tests, at small sizes) the energy is not read and the
    trace holds no device event."""
    import torch

    from portbench import compare, counts, devtrace, drive, spans, spec

    cuda = torch.device(device).type == "cuda"
    cfg, traffic, model_file = cell.config, cell.traffic, cell.model
    fields = model_file.compared_fields(cfg)
    dt = float(cfg["dycore"]["dt"])

    parts = {"imports": time.perf_counter() - T0}
    with (spans.recording() if trace else contextlib.nullcontext([])
          ) as setup_records:
        model = model_file.build_program(cfg, device)
    parts["build"] = time.perf_counter() - T0 - sum(parts.values())
    state = model_file.initial_state(model, traffic, seed)
    parts["initial_state"] = time.perf_counter() - T0 - sum(parts.values())
    # the peak before the check holds any state
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    warm = drive.free_run(model, state, traffic,
                          steps=traffic["warmup_steps"], hold=(0,))
    parts["warm_up"] = time.perf_counter() - T0 - sum(parts.values())
    del state
    card = None
    if cuda:
        from portbench.energy import Card

        card = Card(torch.device(device).index or 0)
    picks = drive.picks(traffic, seed)
    setup_s = time.perf_counter() - T0
    e0 = card.energy_j() if card else None
    win = drive.free_run(model, warm.state, traffic, seconds=seconds,
                         hold=picks)
    energy_j = card.energy_j() - e0 if card else None
    final_state = win.state
    if trace:
        events, span_list, calls, final_state = trace_steps(
            model, win.state, traffic, device)
    found = forbidden_modules()
    ok_final = finite(final_state, fields)
    # The program's own peak: the states the check holds (cloned at the
    # compared steps, all within the window's first steps, and kept to the
    # end) are left out.  Every step after the last clone allocates as the
    # steps before it, so the peak less the held bytes is the step's peak.
    held_bytes = warm.held_bytes + win.held_bytes
    peak_all = torch.cuda.max_memory_allocated(device) if cuda else 0
    memory_peak = max(setup_peak, peak_all - held_bytes)
    print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in parts.items())
          + f"; peak memory {memory_peak} bytes ({peak_all} with the "
          f"check's held states, {held_bytes} bytes)", file=sys.stderr)

    steps = compare.compared_steps(warm.held, win.held)
    result_window = WindowRecord(win.steps, win.window_s, win.intervals_s,
                                 dt, energy_j, setup_s)
    wall_s_per_step = win.window_s / win.steps
    issue_s = win.issue_s
    # the program's state is freed before the reference runs
    del model, warm, win, final_state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = model_file.build_reference(cfg, device)
    checks = compare.checks(compare.gap_table(
        ref, model_file.reference_initial(ref, traffic, seed), steps, fields),
        ok_final)
    del ref, steps
    failed = compare.failed(checks)

    result = {"correct": failed == 0 and not found,
              "attempted": result_window.steps, "failed": failed}
    if trace:
        b = devtrace.busy(events)
        rec = TraceRecord(events=events, steps=traffic["trace_steps"],
                          busy_s=b["busy_s"], window_s=b["span_s"],
                          calls=model_file.step_calls(cfg),
                          peaks=counts.PEAKS[torch.cuda.get_device_name(
                              device)] if cuda else None,
                          wall_s_per_step=wall_s_per_step, issue_s=issue_s,
                          spans=span_list, runtime_calls=calls)
        result["metrics"] = spec.read_metrics(cell.per_layer, "metrics", rec,
                                              cell.root)
    else:
        result["metrics"] = spec.read_metrics(cell.end_to_end, "end_to_end",
                                              result_window, cell.root)
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    if card:
        result["device"]["power_limit_w"] = card.power_limit_w
        card.close()
    if trace:
        result["device"]["busy_s"] = b["busy_s"]
        result["device"]["window_s"] = b["span_s"]
        result["breakdown"] = {"device_ops": devtrace.top_ops(events),
                               "idle_gaps": devtrace.idle_gaps(events),
                               **spans.breakdown(spans.analyse(rec),
                                                 setup_records)}
    result["forbidden_modules"] = found
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = sorted(set(forbidden_modules()) | set(result["forbidden_modules"]))
    if found:
        print("portbench: modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    del result["forbidden_modules"]
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

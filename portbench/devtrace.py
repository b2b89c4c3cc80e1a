"""Reading a torch.profiler Chrome trace: the device's events, their busy
union, the port's kernel stages, and where the device sat idle.

Frozen copies, at commit f902e7ad95fb, of
geosongpu_tpu_torch/hws/xprof_util.py (the device categories and the union
of their intervals, `device_busy`) and of geosongpu_tpu_torch/scripts/
roofline.py (STAGE_OWNER, LEADING, `stage_of`, `wrapper_times`: a launch
of a port wrapper runs its leading stages, fvtp2d_tile and hydro_columns,
and ends with the stage STAGE_OWNER names).
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import List, NamedTuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# __global__ stage -> the wrapper whose launch it ends; the stages not
# named here (fvtp2d_tile, hydro_columns) lead into the next ending stage
STAGE_OWNER = {
    "csw1": "dsw_csw1", "csw2_winds": "dsw_csw2",
    "transport_update": "dsw_transport",
    "nh_transport_update": "dsw_transport", "wind_update": "dsw_wind",
    "tracer_update": "dsw_tracer_acc", "tracer_sub_update": "dsw_tracer",
    "nh_columns": "dsw_nh_pert", "nh_vertical_columns": "nh_vertical_solve",
    "remap_banded_kernel": "remap_banded",
}
LEADING = ("fvtp2d_tile", "hydro_columns")


class Event(NamedTuple):
    ts: float      # start, us
    dur: float     # us
    name: str
    cat: str       # one of DEVICE_CATEGORIES
    launch: str    # the runtime call that launched it, or ""


def read_trace(path: str) -> List[Event]:
    """The device events of one Chrome trace of device activity alone, in
    start order, each with the runtime call that launched it (matched by
    the profiler's "correlation")."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    calls = {e["args"]["correlation"]: e["name"] for e in events
             if e.get("ph") == "X"
             and e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in (e.get("args") or {})}
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            host = calls.get((e.get("args") or {}).get("correlation"), "")
            out.append(Event(float(e["ts"]), float(e["dur"]), e["name"],
                             e["cat"], host))
    out.sort()
    return out


def merged_intervals(events) -> list:
    """The events' intervals as disjoint (start, end) pairs in us, sorted;
    overlapping intervals count once."""
    merged = []
    for e in sorted(events):
        s, t = e.ts, e.ts + e.dur
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t))
        else:
            merged.append((s, t))
    return merged


def busy(events) -> dict:
    """{busy_s, span_s}: the union of the events' intervals, and the span
    from the first start to the last end."""
    merged = merged_intervals(events)
    if not merged:
        return {"busy_s": 0.0, "span_s": 0.0}
    return {"busy_s": sum(t - s for s, t in merged) / 1e6,
            "span_s": (merged[-1][1] - merged[0][0]) / 1e6}


def stage_of(name: str):
    """The port's stage a kernel event names ("...::csw1(...)",
    "...::fvtp2d_tile<2>(...)"), or None for any other kernel."""
    for stage in tuple(STAGE_OWNER) + LEADING:
        if f"::{stage}(" in name or f"::{stage}<" in name:
            return stage
    return None


def wrapper_times(events) -> dict:
    """{wrapper: total device us} of the port's kernels among `events`: a
    leading stage's time goes to the launch its next ending stage ends.
    Raises on a leading stage with no ending stage after it."""
    times, pending = defaultdict(float), 0.0
    for e in events:
        if e.cat != "kernel":
            continue
        stage = stage_of(e.name)
        if stage in LEADING:
            pending += e.dur
        elif stage is not None:
            times[STAGE_OWNER[stage]] += pending + e.dur
            pending = 0.0
    if pending:
        raise ValueError("a leading stage without the stage that ends its "
                         "launch")
    return dict(times)


def top_ops(events, n: int = 10) -> list:
    """[[name, seconds], ...]: the n device operations that took most time."""
    times = defaultdict(float)
    for e in events:
        times[short(e.name)] += e.dur / 1e6
    return [[k, v] for k, v in sorted(times.items(),
                                      key=lambda kv: -kv[1])[:n]]


def short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def idle_gaps(events, n: int = 10) -> list:
    """[[name, seconds], ...]: the device's idle time between its busy
    intervals, summed by what the host was launching when it ended: the
    runtime call of the event that ends the gap where the trace records
    one, else that event's own name; the n largest."""
    gaps, end = defaultdict(float), None
    for e in sorted(events):
        if end is not None and e.ts > end:
            gaps["before " + short(e.launch or e.name)] += (e.ts - end) / 1e6
        end = e.ts + e.dur if end is None else max(end, e.ts + e.dur)
    return [[k, v] for k, v in sorted(gaps.items(),
                                      key=lambda kv: -kv[1])[:n]]

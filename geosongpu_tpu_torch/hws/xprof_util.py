"""Device duty cycle from a torch.profiler trace (measured, not modelled;
the port's form of geosongpu_tpu/hws/xprof_util.py).

A Chrome trace of torch.profiler (`export_chrome_trace`) records every
device event's interval: the `ph == "X"` events whose `cat` is `kernel`,
`gpu_memcpy` or `gpu_memset`.  The host's `cuda_runtime` calls are not
device events.  The union of the device intervals over the trace's span is
the measured duty cycle; nested or overlapping intervals (several streams)
are counted once, as in the original.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def newest_trace(trace_dir: str) -> str:
    paths = (glob.glob(f"{trace_dir}/**/*.pt.trace.json", recursive=True)
             + glob.glob(f"{trace_dir}/**/*.pt.trace.json.gz",
                         recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {trace_dir}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def device_intervals(trace_dir: str) -> List[Tuple[float, float]]:
    """The newest trace's device events as disjoint (start, end) intervals
    in us, sorted."""
    path = newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    merged: List[Tuple[float, float]] = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t))
        else:
            merged.append((s, t))
    return merged


def device_busy(trace_dir: str) -> Dict[str, float]:
    """{busy_s, span_s, duty} of the newest trace under trace_dir.

    busy_s: the union of the device events' intervals; span_s: first
    event's start to last event's end; duty: busy/span."""
    merged = device_intervals(trace_dir)
    if not merged:
        return {"busy_s": 0.0, "span_s": 0.0, "duty": 0.0}
    busy = sum(t - s for s, t in merged)
    span = merged[-1][1] - merged[0][0]
    return {"busy_s": busy / 1e6, "span_s": span / 1e6,
            "duty": busy / span if span else 0.0}


def duty_series(trace_dir: str, bucket_s: float = 0.1
                ) -> Tuple[list, list]:
    """(times, duty): the device's busy share in each bucket of bucket_s
    seconds from the first device event, the utilization series the
    original's NVML sampler produced, from the trace."""
    merged = device_intervals(trace_dir)
    if not merged:
        return [], []
    t0 = merged[0][0]
    bus = bucket_s * 1e6
    nb = max(1, int((merged[-1][1] - t0) / bus) + 1)
    acc = [0.0] * nb
    for s, t in merged:
        for b in range(int((s - t0) / bus), int((t - t0) / bus) + 1):
            lo = t0 + b * bus
            acc[b] += max(0.0, min(t, lo + bus) - max(s, lo))
    times = [b * bucket_s for b in range(nb)]
    duty = [min(1.0, a / bus) for a in acc]
    return times, duty

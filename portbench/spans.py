"""The program's spans read against the device trace of the same steps.

The program (geosongpu_tpu_torch/spans.py) records named host intervals
at its layer boundaries on `time.time_ns()`.  torch.profiler's Chrome
trace stamps its host events, the CUDA runtime and driver calls among
them, in microseconds after the trace's `baseTimeNanoseconds`: a span's
nanoseconds t lie at (t - base) / 1000 on the trace's clock.  On that
clock this module

* puts each device event (kernel, copy, set) down to the innermost span
  that was open when the host issued the runtime call that launched it;
* splits each idle gap of the device over the innermost spans the host
  was in during the gap, the time in no span as an entry of its own
  (OUTSIDE: the benchmark's own loop and its waits);
* checks the mapping: `span_launch_match` is the share of the port's
  hand-kernel launches (devtrace.stage_of) whose runtime call lies inside
  a `kernel.<wrapper>` span of the wrapper that owns the launched stage
  (devtrace.STAGE_OWNER; a leading stage belongs to the launch its next
  ending stage ends).  The span metrics read nothing below MATCH_MIN;

and splits the host time inside `step` spans three ways: inside a
`kernel.*` span (the wrappers), inside a `halo.*` or `exchange.*` span
(the fills and the exchange), and the rest (the glue's dispatch).

`portbench/run.py --trace 1` records the spans around the build and the
traced steps and keeps the trace's runtime calls in its TraceRecord; the
five span metrics (LAYER_METRICS, a reader file each under
portbench/metrics/) and its `breakdown` read them here.  A program without
the recorder (an older checkout of it) records nothing, and nothing is
read.
"""
from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict
from typing import List, NamedTuple

from portbench.devtrace import STAGE_OWNER, merged_intervals, stage_of

OUTSIDE = "outside any span"
NO_CALL = "no runtime call"
KERNEL = ("kernel.",)
HALO = ("halo.", "exchange.")
MATCH_MIN = 0.99
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Span(NamedTuple):
    name: str
    start: float    # us on the trace's clock
    end: float
    parent: int     # index of the enclosing span, -1 at the root
    step: int       # index of the enclosing `step` span, -1 outside any


class RuntimeCall(NamedTuple):
    ts: float       # host start, us on the trace's clock
    name: str
    events: tuple   # indexes of the device events it launched


def recording():
    """The program's span recording, or a block that records nothing where
    the program has no recorder.  Yields the list of its records."""
    try:
        from geosongpu_tpu_torch import spans
    except ImportError:
        return contextlib.nullcontext([])
    return spans.recording()


def read_calls(path: str, events: list):
    """(baseTimeNanoseconds, [RuntimeCall]) of the Chrome trace at `path`:
    every runtime and driver call, with the indexes in `events` (devtrace.
    read_trace of the same file) of the device events it launched, matched
    by the profiler's "correlation"."""
    with open(path) as f:
        trace = json.load(f)
    raw = trace.get("traceEvents", [])
    corr_of = defaultdict(list)
    for e in raw:
        args = e.get("args") or {}
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            corr_of[(float(e["ts"]), float(e["dur"]), e["name"],
                     e["cat"])].append(args.get("correlation"))
    launched = defaultdict(list)
    for i, ev in enumerate(events):
        hits = corr_of.get((ev.ts, ev.dur, ev.name, ev.cat))
        c = hits.pop(0) if hits else None
        if c is not None:
            launched[c].append(i)
    calls = [RuntimeCall(float(e["ts"]), e["name"],
                         tuple(launched.get(e["args"]["correlation"], ())))
             for e in raw if e.get("ph") == "X"
             and e.get("cat") in RUNTIME_CATEGORIES
             and "correlation" in (e.get("args") or {})]
    calls.sort()
    return int(trace.get("baseTimeNanoseconds", 0)), calls


def on_trace_clock(records, base_ns: int) -> List[Span]:
    """The program's span records (name, start_ns, end_ns, parent, step)
    as Spans in us on the clock of a trace whose baseTimeNanoseconds is
    `base_ns`."""
    return [Span(r[0], (r[1] - base_ns) / 1e3, (r[2] - base_ns) / 1e3,
                 r[3], r[4]) for r in records]


class Timeline:
    """Spans flattened into disjoint segments, each the part of a span
    that none of its children covers (its self time)."""

    def __init__(self, spans: List[Span]):
        self.spans = spans
        children = defaultdict(list)
        for i, s in enumerate(spans):
            children[s.parent].append(i)
        segs = []
        for i, s in enumerate(spans):
            t = s.start
            for c in children[i]:
                if spans[c].start > t:
                    segs.append((t, spans[c].start, i))
                t = max(t, spans[c].end)
            if s.end > t:
                segs.append((t, s.end, i))
        segs.sort()
        self.segs = segs
        self.starts = [s[0] for s in segs]
        self._chains = {}

    def at(self, t: float) -> int:
        """The innermost span open at t, or -1."""
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and t < self.segs[k][1]:
            return self.segs[k][2]
        return -1

    def overlaps(self, a: float, b: float):
        """(span, us) of each segment's overlap with [a, b)."""
        k = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while k < len(self.segs) and self.segs[k][0] < b:
            s, e, i = self.segs[k]
            d = min(b, e) - max(a, s)
            if d > 0:
                yield i, d
            k += 1

    def chain(self, i: int) -> tuple:
        """The names of span i and of every span around it."""
        hit = self._chains.get(i)
        if hit is None:
            s = self.spans[i]
            hit = (s.name,) + (self.chain(s.parent) if s.parent >= 0
                               else ())
            self._chains[i] = hit
        return hit

    def inside(self, i: int, prefixes) -> bool:
        return i >= 0 and any(n.startswith(prefixes) for n in self.chain(i))

    def part(self, i: int) -> str:
        """The share of the step that span i's self time belongs to:
        "wrapper", "halo", "glue", or None outside any step."""
        if i < 0 or self.spans[i].step < 0:
            return None
        if self.inside(i, KERNEL):
            return "wrapper"
        if self.inside(i, HALO):
            return "halo"
        return "glue"


def owners(events) -> dict:
    """{index of a hand-kernel event: the wrapper that launched it}: an
    ending stage's STAGE_OWNER, a leading stage's that of the next ending
    stage."""
    out, pending = {}, []
    for i, e in enumerate(events):
        if e.cat != "kernel":
            continue
        stage = stage_of(e.name)
        if stage is None:
            continue
        if stage in STAGE_OWNER:
            for j in pending + [i]:
                out[j] = STAGE_OWNER[stage]
            pending = []
        else:
            pending.append(i)
    return out


def analyse(rec) -> dict:
    """The spans of a TraceRecord against its device events, per step
    (rec.steps): by_span ({name: host_ms, host_self_ms, device_ms,
    device_self_ms, launches}, a span's device ms those launched inside
    it, its self ms those whose innermost span it is), idle_by_span
    (seconds), span_launch_match, host_ms (the step's wrapper, halo and
    glue parts) and device_ms (halo, remap); None where the record holds
    no spans."""
    if not getattr(rec, "spans", None):
        return None
    tl = Timeline(rec.spans)
    steps = rec.steps
    launch_span = {}
    for call in rec.runtime_calls:
        if call.events:
            i = tl.at(call.ts)
            for j in call.events:
                launch_span[j] = i

    by = defaultdict(lambda: defaultdict(float))
    for i, s in enumerate(rec.spans):
        by[s.name]["host_ms"] += s.end - s.start
    parts = defaultdict(float)
    for s, e, i in tl.segs:
        by[rec.spans[i].name]["host_self_ms"] += e - s
        p = tl.part(i)
        if p is not None:
            parts[p] += e - s
    device = defaultdict(float)   # us by layer key
    for j, ev in enumerate(rec.events):
        i = launch_span.get(j)
        if i is None:
            name = NO_CALL
        elif i < 0:
            name = OUTSIDE
        else:
            name = rec.spans[i].name
            for n in set(tl.chain(i)):
                by[n]["device_ms"] += ev.dur
            if tl.inside(i, HALO):
                device["halo"] += ev.dur
            if "remap" in tl.chain(i):
                device["remap"] += ev.dur
        by[name]["device_self_ms"] += ev.dur
        if ev.cat == "kernel":
            by[name]["launches"] += 1
    by_span = {n: {k: v / 1e3 / steps if k != "launches" else v / steps
                   for k, v in vals.items()} for n, vals in by.items()}

    hand = owners(rec.events)
    in_owner = sum(1 for j, w in hand.items()
                   if launch_span.get(j, -1) >= 0
                   and "kernel." + w in tl.chain(launch_span[j]))
    match = in_owner / len(hand) if hand else None

    idle = defaultdict(float)
    merged = merged_intervals(rec.events)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        covered = 0.0
        for i, d in tl.overlaps(a, b):
            idle[rec.spans[i].name] += d
            covered += d
        if b - a > covered:
            idle[OUTSIDE] += b - a - covered
    return {
        "by_span": by_span,
        "idle_by_span": [[k, v / 1e6] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10]],
        "span_launch_match": match,
        "host_ms": {k: v / 1e3 / steps for k, v in parts.items()},
        "device_ms": {k: v / 1e3 / steps for k, v in device.items()},
    }


# The span metrics: {name: (analyse's key, part)}, ms a step.  Each reads
# nothing where the spans do not line up with the trace.
LAYER_METRICS = {
    "halo_device_ms": ("device_ms", "halo"),
    "halo_host_ms": ("host_ms", "halo"),
    "wrapper_host_ms": ("host_ms", "wrapper"),
    "glue_host_ms": ("host_ms", "glue"),
    "remap_layer_device_ms": ("device_ms", "remap"),
}


def layer_metrics(a) -> dict:
    """{metric of LAYER_METRICS: ms a step} of an analysis; empty where
    there is none or the mapping fails (span_launch_match below
    MATCH_MIN)."""
    if a is None or a["span_launch_match"] is None or \
            a["span_launch_match"] < MATCH_MIN:
        return {}
    return {n: a[key].get(part, 0.0)
            for n, (key, part) in LAYER_METRICS.items()}


def setup_seconds(records) -> dict:
    """{span name: seconds} summed over the set-up's records (a span's
    whole duration, its children's included)."""
    out = defaultdict(float)
    for r in records:
        out[r[0]] += (r[2] - r[1]) / 1e9
    return dict(out)


def breakdown(a, setup_records) -> dict:
    """by_span, idle_by_span, setup_by_span and span_launch_match of an
    analysis; nothing where there is none (the program recorded no
    span)."""
    if a is None:
        return {}
    return {"by_span": a["by_span"], "idle_by_span": a["idle_by_span"],
            "setup_by_span": setup_seconds(setup_records),
            "span_launch_match": a["span_launch_match"]}

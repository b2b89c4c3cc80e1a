"""Profiler hooks and roofline accounting (the port's form of
geosongpu_tpu/benchmark/profiler.py).

`trace` records a torch.profiler window (host and, on a card, device
activity) and writes its Chrome trace under a directory, where
`hws.xprof_util` reads the device's busy time.  `annotation` names a region
as a span of the program's one span recorder (spans.py) and as a labelled
range in that trace.  `TimedRegion` is the accumulating wall-clock timer,
`Roofline` the achieved bytes/s of a measured byte count against the
card's nameplate HBM rate.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List

import torch

from ..device import synchronize
from ..spans import span

CARD = "NVIDIA H100 80GB HBM3"

# Peak HBM bandwidth per card [bytes/s] (the data sheet's nameplate)
HBM_PEAK = {
    CARD: 3.35e12,
}


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU activity, and CUDA's on a card device) and
    write its Chrome trace to log_dir/trace_<ns>_<pid>.pt.trace.json.
    Yields the profiler, whose events() the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.time_ns()}_{os.getpid()}.pt.trace.json"))


@contextlib.contextmanager
def annotation(name: str) -> Iterator[None]:
    """A span `name` (recorded while spans.recording() is open) and a
    range of that name among the profiler's host events."""
    with span(name), torch.profiler.record_function(name):
        yield


class TimedRegion:
    """Accumulating wall-clock timer per label; with a device, the block's
    queued work is waited for before the clock stops."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def __call__(self, label: str, device=None):
        t0 = time.perf_counter()
        yield
        if device is not None:
            synchronize(device)
        self.times.setdefault(label, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for k, v in sorted(self.times.items()):
            lines.append(f"{k}: n={len(v)} total={sum(v)*1e3:.2f} ms "
                         f"mean={sum(v)/len(v)*1e3:.3f} ms")
        return "\n".join(lines)


@dataclass
class Roofline:
    label: str
    bytes_accessed: float
    seconds: float
    chip: str = CARD

    @property
    def achieved_bw(self) -> float:
        return self.bytes_accessed / self.seconds

    @property
    def fraction_of_peak(self) -> float:
        return self.achieved_bw / HBM_PEAK[self.chip]

    def __str__(self) -> str:
        return (f"{self.label}: {self.achieved_bw/1e9:.1f} GB/s = "
                f"{self.fraction_of_peak*100:.1f}% of {self.chip} HBM peak")


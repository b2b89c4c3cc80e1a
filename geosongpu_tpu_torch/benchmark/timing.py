"""Structured benchmark timings (the port's copy of
geosongpu_tpu/benchmark/timing.py).

A run emits a structured record: per-step wall times with the warm-up
steps (here the kernels' build and the allocator's first fills) kept apart,
plus the derived metrics of a benchmark report (global run time, median
step, gridpoints/s).  The JSON schema is the original's, so each package
loads the other's files and the round-over-round comparison reads
artifacts written by either.  The `tpu_kwh` key of `energy` is a schema
name kept for that reason.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class BenchmarkRecord:
    """One run's timing record."""

    experiment: str
    backend: str                      # "cuda:fused" | "cpu:eager" | ...
    grid: Dict[str, int]              # {npx, npz}
    setup_time_s: float = 0.0
    compile_time_s: float = 0.0       # warm-up time, excluded from steps
    step_time_s: List[float] = field(default_factory=list)
    extra: Dict[str, float] = field(default_factory=dict)
    # measured hierarchical phase breakdown (benchmark/phases.py
    # PhaseTree.to_dict())
    phase_tree: Optional[dict] = None
    # energy envelope of the run: {cpu_kwh, tpu_kwh, total_kwh}
    energy: Optional[dict] = None

    @property
    def total_run_s(self) -> float:
        return sum(self.step_time_s)

    @property
    def median_step_s(self) -> float:
        return statistics.median(self.step_time_s) if self.step_time_s else 0.0

    @property
    def grid_points(self) -> int:
        return 6 * self.grid["npx"] * self.grid["npx"] * self.grid["npz"]

    @property
    def grid_points_per_s(self) -> float:
        m = self.median_step_s
        return self.grid_points / m if m > 0 else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["derived"] = {
            "total_run_s": self.total_run_s,
            "median_step_s": self.median_step_s,
            "grid_points": self.grid_points,
            "grid_points_per_s": self.grid_points_per_s,
        }
        return d

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "BenchmarkRecord":
        with open(path) as f:
            d = json.load(f)
        d.pop("derived", None)
        return cls(**d)


class StepTimer:
    """Wall-clock step timer; the caller synchronises the device before
    stop()."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        assert self._t0 is not None
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None


def compare(a: BenchmarkRecord, b: BenchmarkRecord) -> Dict[str, float]:
    """Speed-ups of the global run and of the median step, b relative to
    a, and the energy ratio where both records carry one."""
    out = {}
    if b.total_run_s > 0:
        out["speedup_total_run"] = a.total_run_s / b.total_run_s
    if b.median_step_s > 0:
        out["speedup_median_step"] = a.median_step_s / b.median_step_s
    out["grid_points_per_s_a"] = a.grid_points_per_s
    out["grid_points_per_s_b"] = b.grid_points_per_s
    ea = (a.energy or {}).get("total_kwh", 0.0)
    eb = (b.energy or {}).get("total_kwh", 0.0)
    if ea > 0 and eb > 0:
        out["energy_kwh_a"] = ea
        out["energy_kwh_b"] = eb
        out["energy_ratio"] = ea / eb
    return out


def report(records: List[BenchmarkRecord]) -> str:
    """Text report over a set of runs sharing a grid: one line a run, its
    phase breakdown, then every pair compared."""
    if not records:
        return "no benchmark records"
    grids = {json.dumps(r.grid, sort_keys=True) for r in records}
    lines = []
    if len(grids) > 1:
        lines.append(f"WARNING: mixed grids in report: {grids}")
    lines.append(f"# Benchmark report ({len(records)} runs)")
    for r in records:
        lines.append(
            f"- {r.experiment} [{r.backend}] c{r.grid['npx']}-L{r.grid['npz']}: "
            f"median step {r.median_step_s*1e3:.2f} ms, "
            f"total {r.total_run_s:.2f} s over {len(r.step_time_s)} steps, "
            f"compile {r.compile_time_s:.2f} s, "
            f"{r.grid_points_per_s:,.0f} gridpoints/s")
        if r.energy:
            lines.append(
                f"  energy: {r.energy.get('total_kwh', 0.0):.6f} kWh "
                f"(tpu {r.energy.get('tpu_kwh', 0.0):.6f}, "
                f"cpu {r.energy.get('cpu_kwh', 0.0):.6f})")
        if r.phase_tree:
            pt = r.phase_tree
            lines.append("  phase breakdown (measured, per step):")
            for k, v in sorted(pt.get("phases_ms", {}).items(),
                               key=lambda kv: -kv[1]):
                pct = pt.get("phases_pct", {}).get(k, 0.0)
                lines.append(f"    {k:<24s} {v:8.2f} ms {pct:5.1f}%")
            lines.append(
                f"    {'(unaccounted)':<24s} "
                f"{pt.get('unaccounted_ms', 0.0):8.2f} ms")
    for i in range(len(records)):
        for j in range(i + 1, len(records)):
            a, b = records[i], records[j]
            c = compare(a, b)
            line = (
                f"- {b.experiment}[{b.backend}] vs {a.experiment}[{a.backend}]: "
                f"total x{c.get('speedup_total_run', float('nan')):.2f}, "
                f"median step x{c.get('speedup_median_step', float('nan')):.2f}")
            if "energy_ratio" in c:
                line += f", energy x{c['energy_ratio']:.2f}"
            lines.append(line)
    return "\n".join(lines)

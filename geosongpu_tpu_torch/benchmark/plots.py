"""Benchmark visualizations (the port's copy of
geosongpu_tpu/benchmark/plots.py).

The reference's plotly sunburst of the GridComp timer hierarchy and its
per-step dycore scatter (tcn/benchmark/benchmark.py:134-157, report.py:
38-72, 222-225), with matplotlib: a per-step time scatter of
BenchmarkRecords, a component bar chart and a ring chart of a record's
phase tree.  The records are the port's benchmark/timing.py ones, whose
JSON schema is the original's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .timing import BenchmarkRecord


def step_scatter(records: List[BenchmarkRecord],
                 out_png: str = "steps.png") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 4.5))
    for r in records:
        ax.plot(np.arange(len(r.step_time_s)),
                np.asarray(r.step_time_s) * 1e3, "o-", ms=3,
                label=f"{r.experiment} [{r.backend}]")
    ax.set_xlabel("step")
    ax.set_ylabel("wall time [ms]")
    ax.set_title("per-step time (warm-up excluded)")
    ax.legend()
    fig.savefig(out_png, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_png


def component_bars(component_times: Dict[str, float],
                   out_png: str = "components.png",
                   title: str = "step component breakdown") -> str:
    """Horizontal stacked view of component timings (sunburst analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    items = sorted(component_times.items(), key=lambda kv: -kv[1])
    names = [k for k, _ in items]
    vals = [v * 1e3 for _, v in items]
    fig, ax = plt.subplots(figsize=(8, 0.5 * len(items) + 1.5))
    ax.barh(names[::-1], vals[::-1], color="#105bd8")
    ax.set_xlabel("time [ms]")
    ax.set_title(title)
    for y, v in enumerate(vals[::-1]):
        ax.text(v, y, f" {v:.2f}", va="center", fontsize=8)
    fig.savefig(out_png, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_png


def phase_sunburst(record: BenchmarkRecord,
                   out_png: str = "phase_sunburst.png") -> str:
    """Ring chart of the measured phase tree (the reference renders its
    mined GridComp hierarchy as a plotly sunburst, benchmark.py:134-157;
    ours is measured by benchmark/phases.py, not scraped)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pt = record.phase_tree or {}
    phases = dict(pt.get("phases_ms", {}))
    if not phases:
        raise ValueError("record has no phase_tree")
    phases["(unaccounted)"] = pt.get("unaccounted_ms", 0.0)
    items = sorted(phases.items(), key=lambda kv: -kv[1])
    labels = [f"{k}\n{v:.1f} ms" for k, v in items]
    vals = [max(v, 0.0) for _, v in items]

    fig, ax = plt.subplots(figsize=(7, 7))
    ax.pie(vals, labels=labels, wedgeprops=dict(width=0.42),
           startangle=90, textprops={"fontsize": 9})
    total = pt.get("full_step_ms", sum(vals))
    ax.text(0, 0, f"step\n{total:.1f} ms", ha="center", va="center",
            fontsize=13)
    ax.set_title(f"{record.experiment} [{record.backend}] "
                 f"c{record.grid['npx']}-L{record.grid['npz']}")
    fig.savefig(out_png, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_png

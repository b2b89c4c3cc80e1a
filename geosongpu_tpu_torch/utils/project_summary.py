"""Team-backlog distribution plots (the port's copy of
geosongpu_tpu/utils/project_summary.py; the reference's tcn/project/
summary.py:10-33): pie charts of a backlog TSV with columns such as
Status / Domains / Workers."""
from __future__ import annotations

import collections
import csv
from typing import Dict, List


def read_backlog(tsv_path: str) -> List[Dict[str, str]]:
    with open(tsv_path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def distribution(rows: List[Dict[str, str]], column: str) -> Dict[str, int]:
    c = collections.Counter()
    for row in rows:
        for value in (row.get(column, "") or "unset").split(","):
            c[value.strip() or "unset"] += 1
    return dict(c)


def summary_plots(tsv_path: str, columns=("Status", "Domains"),
                  out_png: str = "project_summary.png") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = read_backlog(tsv_path)
    fig, axes = plt.subplots(1, len(columns), figsize=(6 * len(columns), 5))
    if len(columns) == 1:
        axes = [axes]
    for ax, col in zip(axes, columns):
        dist = distribution(rows, col)
        ax.pie(dist.values(), labels=list(dist.keys()), autopct="%1.0f%%")
        ax.set_title(f"{col} ({len(rows)} items)")
    fig.savefig(out_png, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_png

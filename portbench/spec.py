"""What the benchmark runs, found by name.

`BENCHMARK.json` at the root of the checkout names the cells, their
configurations and traffic, and the metrics.  Each part lives in a file of
its own, so that a configuration, a traffic mix or a metric is added by
adding a file and an entry:

* a configuration: the `file` of its entry (`portbench/configs/<name>.json`);
* a traffic mix: `portbench/traffic/<traffic>.json`, parameters that the
  one generator of portbench/drive.py reads;
* an end-to-end metric: `portbench/end_to_end/<name>.py`, a per-layer
  metric: `portbench/metrics/<name>.py`, each with `read(record)`, which
  returns the metric's value or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file: its "dycore" fields etc.
    traffic: dict
    end_to_end: list    # BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path = ROOT   # the checkout it was found in


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return _json(path)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(root / configs[w["config"]]["file"]),
        traffic=_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root)


def reader(kind: str, name: str, root: Path = ROOT):
    """The module of metric `name`: kind "end_to_end" or "metrics"."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(entries: list, kind: str, record, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of the metrics `entries` that find
    something to read in `record`."""
    out = {}
    for m in entries:
        value = reader(kind, m["name"], root).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

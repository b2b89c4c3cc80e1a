"""A configuration, a traffic mix, a cell and metrics are added by new
files and new entries alone, and found by name; a CPU run of the new cell
at a small size reads the new metric."""
import json
import shutil

import pytest

from portbench import spec
from pbhelpers import ROOT, load_run


@pytest.fixture
def copy(tmp_path):
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(f"{ROOT}/portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _add(copy):
    cfg = json.loads((copy / "portbench/configs/held_suarez_c192.json")
                     .read_text())
    cfg["name"] = "held_suarez_c8"
    cfg["dycore"].update(npx=8, npz=6)
    (copy / "portbench/configs/held_suarez_c8.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((copy / "portbench/traffic/free.json").read_text())
    traffic.update(in_flight=1, pick_steps=3)
    (copy / "portbench/traffic/lockstep.json").write_text(
        json.dumps(traffic))
    (copy / "portbench/end_to_end/steps_per_s.py").write_text(
        "def read(rec):\n    return rec.steps / rec.window_s\n")
    (copy / "portbench/metrics/a.new-metric.py").write_text(
        "def read(rec):\n    return 42.0\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "held_suarez_c8", "source": "a test",
        "file": "portbench/configs/held_suarez_c8.json", "reduced": ["npx"],
        "why": "a test"})
    bench["workloads"].append({
        "name": "hs_c8.lockstep", "config": "held_suarez_c8",
        "traffic": "lockstep", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "steps_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["hs_c8.lockstep"]})
    bench["per_layer"].append({
        "name": "a.new-metric", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "a test",
        "moves": "steps_per_s", "workloads": ["hs_c8.lockstep"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found_by_name(copy):
    _add(copy)
    c = spec.cell("hs_c8.lockstep", root=copy)
    assert c.config["dycore"]["npx"] == 8
    assert c.traffic["in_flight"] == 1
    assert [m["name"] for m in c.end_to_end][-1] == "steps_per_s"
    assert "a.new-metric" in [m["name"] for m in c.per_layer]
    assert spec.reader("metrics", "a.new-metric", copy).read(None) == 42.0
    # the cells already there do not report the new cell's metrics
    old = spec.cell("hs_c192_l72.free", root=copy)
    assert "steps_per_s" not in [m["name"] for m in old.end_to_end]
    assert "nh_solve_device_ms" not in [m["name"] for m in old.per_layer]
    assert "nh_solve_device_ms" in [
        m["name"] for m in spec.cell("nh_c192_l72.free", root=copy).per_layer]


def test_a_new_cell_runs(copy):
    _add(copy)
    c = spec.cell("hs_c8.lockstep", root=copy)
    result = load_run().run(c, 2 ** 31 + 7, 0.5, False, "cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"sypd", "setup_s", "steps_per_s"}


def test_unknown_names_are_refused(copy):
    with pytest.raises(KeyError):
        spec.cell("no_such.cell", root=copy)
    with pytest.raises(FileNotFoundError):
        spec.reader("metrics", "no_such_metric", copy)

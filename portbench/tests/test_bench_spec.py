"""A model, a configuration, a traffic mix, a cell and metrics are added
by new files and new entries alone, and found by name; a CPU run of the new
cell at a small size is correct and reads the new metric."""
import hashlib
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


# a model file of its own: the Held-Suarez model under another name
TEST_MODEL = '''"""A test model: the Held-Suarez model under another name."""
from portbench.models.held_suarez import (  # noqa: F401
    build_program, build_reference, compared_fields, initial_state,
    reference_initial, step_calls)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def _add(copy):
    before = _digests(copy)
    (copy / "portbench/models/hs_test_model.py").write_text(TEST_MODEL)
    cfg = json.loads((copy / "portbench/configs/held_suarez_c192.json")
                     .read_text())
    cfg["name"] = "held_suarez_c8"
    cfg["model"] = "hs_test_model"
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
    after = _digests(copy)
    # no file that was there is touched, but the entries of BENCHMARK.json
    assert {p for p in before if after[p] != before[p]} == {
        copy.joinpath("BENCHMARK.json").relative_to(copy)}


def test_new_files_are_found_by_name(copy):
    _add(copy)
    c = spec.cell("hs_c8.lockstep", root=copy)
    assert c.config["dycore"]["npx"] == 8
    assert c.model.__file__ == str(copy / "portbench/models/hs_test_model.py")
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
    with pytest.raises(KeyError, match="have.*held_suarez"):
        spec.model("no_such_model", copy)
    _add(copy)
    path = copy / "portbench/configs/held_suarez_c8.json"
    path.write_text(path.read_text().replace('"hs_test_model"',
                                             '"no_such_model"'))
    with pytest.raises(KeyError, match="no_such_model.*have.*hs_test_model"):
        spec.cell("hs_c8.lockstep", root=copy)


def test_drive_and_compare_name_no_model():
    """The generator and the check reach a model only through its file."""
    names = [p.stem for p in (spec.HERE / "models").glob("*.py")]
    assert "held_suarez" in names
    for f in ("drive.py", "compare.py"):
        text = (spec.HERE / f).read_text().lower()
        for n in names + ["suarez"]:
            assert n not in text, (f, n)

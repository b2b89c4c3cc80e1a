"""On the card: a small cell's run through the benchmark's own path, the
trace and its readers included, and a traced run of a cell at its own
size with the program's spans."""
import json
import subprocess
import sys

import pytest

from portbench import spans
from pbhelpers import ROOT, load_run, small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("hs_c192_l72.free", "nh_c192_l72.free"))
def test_small_run_on_the_card(card, name):
    run = load_run()
    cell = small_cell(name, npx=24, npz=16)
    plain = run.run(cell, 2 ** 31 + 5, 1.0, False, card)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    traced = run.run(cell, 2 ** 31 + 5, 1.0, True, card)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0.0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    for name, m in traced["metrics"].items():
        if m["unit"] == "%":
            assert 0.0 < m["value"] <= 100.0, (name, m)


@pytest.mark.cuda
def test_the_traced_run_prints_the_span_metrics(card):
    """`run.py --trace 1` on hs_c192_l72.free at its own size, as the
    benchmark runs it: the five span metrics and the spans' breakdown are
    in its result line, the launches matched to their wrappers' spans."""
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hs_c192_l72.free",
         "--seed", str(2 ** 31 + 41), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(spans.LAYER_METRICS) <= set(result["metrics"])
    b = result["breakdown"]
    assert b["span_launch_match"] >= spans.MATCH_MIN
    assert b["by_span"]["kernel.dsw_csw1"]["launches"] > 0
    assert {"setup.grid", "setup.context"} <= set(b["setup_by_span"])

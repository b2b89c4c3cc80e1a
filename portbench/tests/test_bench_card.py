"""On the card: a small cell's run through the benchmark's own path, the
trace and its readers included."""
import pytest

from pbhelpers import load_run, small_cell


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

"""The frozen counts of portbench/counts.py against the program's own
recorder (scripts/roofline.py `recording`, which counts each call's
tensors as benchmark/bounds.py does) over one step at small shapes, in
each form the counts know: hydrostatic or not, chart corners or not, the
blend or the exchange damping form, two tracers."""
import dataclasses
import itertools

import pytest

from portbench import counts

FORMS = list(itertools.product((True, False), (True, False),
                               ("blend", "exchange")))


def _cfg(hydrostatic, chart, damping, pallas=True):
    from geosongpu_tpu_torch.core.config import DycoreConfig

    return DycoreConfig(npx=12, npz=8, dt=300.0, n_split=2,
                        pallas_dycore=pallas, hydrostatic=hydrostatic,
                        z_tracer=hydrostatic, ntracers=2,
                        chart_corners=chart, damping_exchange=damping)


def _recorded(cfg, device):
    from geosongpu_tpu_torch.models.held_suarez import build_model
    from geosongpu_tpu_torch.scripts.roofline import recording

    model = build_model(cfg, device)
    state = model.init(perturb=1e-3, seed=3)
    calls = []
    with recording(calls):
        model.step(state)
    return sorted((form, nbytes, points) for _, form, nbytes, points in calls)


def _frozen(cfg, skip=()):
    return sorted((k.form, k.bytes, k.points)
                  for k in counts.step_calls(dataclasses.asdict(cfg))
                  if k.form not in skip)


@pytest.mark.parametrize("hydrostatic,chart,damping", FORMS)
def test_counts_match_the_programs_recorder(hydrostatic, chart, damping):
    """On the CPU the nonhydrostatic dsw_wind runs dsw_nh_pert's plain
    version inside it, which the recorder does not see: the card's test
    below holds that call too."""
    cfg = _cfg(hydrostatic, chart, damping)
    assert _frozen(cfg, skip=("dsw_nh_pert",)) == _recorded(cfg, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("hydrostatic", (True, False))
def test_counts_match_the_recorder_on_the_card(card, hydrostatic):
    cfg = _cfg(hydrostatic, True, "blend")
    assert _frozen(cfg) == _recorded(cfg, card)


def test_counts_refuse_the_eager_step():
    with pytest.raises(ValueError):
        counts.step_calls(dataclasses.asdict(_cfg(True, True, "blend",
                                                  pallas=False)))


def test_bound_is_the_larger_of_bytes_and_operations():
    peaks = {"hbm_bytes_per_s": 1e3, "f32_flop_per_s": 1e3}
    a = counts.Call("dsw_csw1", "dsw_csw1", 10_000, 1)      # bytes: 10 s
    b = counts.Call("dsw_csw1", "dsw_csw1", 1, 1_000)       # 80,000 ops: 80 s
    assert counts.bound_s([a], peaks) == 10.0
    assert counts.bound_s([b], peaks) == 80.0
    assert counts.bound_s([a, b], peaks) == pytest.approx(80.08)
    assert counts.calls_bound_s([a, b], peaks) == 90.0

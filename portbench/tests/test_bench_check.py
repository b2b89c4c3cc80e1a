"""The check that decides `correct`, at c12-L8 on the CPU: the program
passes it, the control (the reference with its state stored in bfloat16)
fails it, and a run with the timed path broken underneath reports
`correct` false, for each fault the cells can have.  On the card, at the
cells' own size: the TF32 control fails, and so does a run whose tracer
transport is skipped."""
import dataclasses

import pytest
import torch

from portbench import compare, drive
from pbhelpers import load_run, small_cell

CELLS = ("hs_c192_l72.free", "nh_c192_l72.free")


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_bf16_state_fails(name):
    """On the CPU, where TF32 does not exist, the reference with its state
    stored in bfloat16 stands in for the control."""
    cell = small_cell(name)
    fields = cell.model.compared_fields(cell.config)
    model = cell.model.build_program(cell.config, "cpu")
    ref = cell.model.build_reference(cell.config, "cpu")
    for seed in (1, 2 ** 31 + 3, 2 ** 32 + 5):
        s = drive.free_run(model, cell.model.initial_state(
            model, cell.traffic, seed), cell.traffic, steps=2).state
        out = model.step(s)
        mine = compare.step_gaps(ref, s, out, fields)
        low = compare.control_gaps(ref, s, fields, "bf16")
        assert max(mine.values()) <= compare.STEP_GAP_LIMIT, mine
        assert max(low.values()) > compare.STEP_GAP_LIMIT, low


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_fails_on_the_card(card, name):
    """The control, the reference with TF32 on in the program's place,
    fails the check on the card at the cell's own size, where the program
    passes.  (At c48-L24 TF32 moved the hydrostatic step by 0.049 only: the
    chart corners' products weigh more against a c192 step's change.)"""
    from portbench import spec

    cell = spec.cell(name)
    fields = cell.model.compared_fields(cell.config)
    model = cell.model.build_program(cell.config, card)
    ref = cell.model.build_reference(cell.config, card)
    for seed in (1, 2 ** 31 + 3, 2 ** 32 + 5):
        s = drive.free_run(model, cell.model.initial_state(
            model, cell.traffic, seed), cell.traffic, steps=3).state
        out = model.step(s)
        mine = compare.step_gaps(ref, s, out, fields)
        low = compare.control_gaps(ref, s, fields, "tf32")
        assert max(mine.values()) <= compare.STEP_GAP_LIMIT, mine
        assert max(low.values()) > compare.STEP_GAP_LIMIT, low


def _unchanged(step):
    return lambda self, state: state


def _altered(step):
    def altered(self, state):
        out = step(self, state)
        pt = out.pt.clone()
        pt[2, 3, 4, 1] += 0.01
        return dataclasses.replace(out, pt=pt)
    return altered


def _half_faces(step):
    """Half of the globe left out: faces 3-5 keep their input."""
    def half(self, state):
        out = step(self, state)
        keep = {}
        for f in ("u", "v", "pt", "delp", "q", "w", "delz", "ps"):
            a = getattr(out, f).clone()
            a[3:] = getattr(state, f)[3:]
            keep[f] = a
        return dataclasses.replace(out, **keep)
    return half


FAULTS = {"state_unchanged": _unchanged, "answer_altered": _altered,
          "half_the_faces_left_out": _half_faces}


def _skip_tracer_transport(monkeypatch):
    """The fused path's tracer transport skipped: dsw_tracer_acc (the
    hydrostatic z_tracer subcycles) and dsw_tracer (the nonhydrostatic
    per-substep tracers) return the tracer they were given."""
    from geosongpu_tpu_torch.ops.kernels import dsw

    acc = dsw.dsw_tracer_acc

    def untransported_acc(qx, *a):
        return acc(qx, *a)[0], qx

    def untransported(qx, *a):
        return (qx,)

    # a wrapper counts its launches on the name that it is bound to
    untransported_acc.launches = untransported.launches = 0
    monkeypatch.setattr(dsw, "dsw_tracer_acc", untransported_acc)
    monkeypatch.setattr(dsw, "dsw_tracer", untransported)


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["exchange_left_out"])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    from geosongpu_tpu_torch.models.held_suarez import HeldSuarezModel
    from geosongpu_tpu_torch.parallel.halo import HaloOps

    if fault == "exchange_left_out":
        fill = HaloOps.fill

        def no_exchange(self, field, direction="x"):
            out = fill(self, field, direction).clone()
            h = self.h
            out[:, :h] = 0.0
            out[:, -h:] = 0.0
            out[:, :, :h] = 0.0
            out[:, :, -h:] = 0.0
            return out

        monkeypatch.setattr(HaloOps, "fill", no_exchange)
    else:
        monkeypatch.setattr(HeldSuarezModel, "step",
                            FAULTS[fault](HeldSuarezModel.step))
    result = load_run().run(small_cell("hs_c192_l72.free"), 2 ** 31 + 11,
                            0.3, False, "cpu")
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_skipped_tracer_transport_is_not_correct(monkeypatch, name):
    """At c12 a 1e-3 K start moves the tracer by ~2e-7 of its size a step,
    under the check's floor of 1e-4 (on the card at c192: 1.4e-4 in the
    first step, 7e-4 by the 15th), so the small cell starts from 1 K of
    noise, which moves it by 5e-5 in the first step and 1.2e-4 in the
    second.  The same run passes unbroken."""
    cell = small_cell(name)
    cell.traffic["perturb"] = 1.0
    run = load_run()
    sound = run.run(cell, 2 ** 31 + 11, 0.3, False, "cpu")
    assert sound["correct"], sound["checks"]
    _skip_tracer_transport(monkeypatch)
    result = run.run(cell, 2 ** 31 + 11, 0.3, False, "cpu")
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 2, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_skipped_tracer_transport_is_not_correct_on_the_card(
        card, monkeypatch, name, capsys):
    """At the cell's own size and traffic, on three seeds: every compared
    step's gap is printed for the record."""
    from portbench import spec

    _skip_tracer_transport(monkeypatch)
    run = load_run()
    for seed in (2 ** 31 + 21, 2 ** 32 + 22, 23):
        result = run.run(spec.cell(name), seed, 2.0, False, card)
        with capsys.disabled():
            print(f"\ntracer transport skipped {name} seed {seed}: "
                  f"{result['checks']}")
        assert result["correct"] is False, result["checks"]


def test_an_unbroken_run_is_correct_and_loads_no_jax():
    result = load_run().run(small_cell("nh_c192_l72.free"), 2 ** 31 + 11,
                            0.3, False, "cpu")
    assert result["correct"], result["checks"]
    assert result["forbidden_modules"] == []
    assert list(result)[-1] == "checks"
    assert torch.get_default_dtype() == torch.float32

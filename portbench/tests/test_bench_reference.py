"""The reference copy against the port's eager step, and the port's fused
step against the reference, at c12-L8 on the CPU, field by field."""
import dataclasses

import pytest
import torch

from portbench import compare
from pbhelpers import small_cell

CELLS = ("hs_c192_l72.free", "nh_c192_l72.free")


def _program(cell, fused):
    cfg = dict(cell.config)
    cfg["dycore"] = dict(cfg["dycore"], pallas_dycore=fused)
    return cell.model.build_program(cfg, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_ports_eager_step(name):
    """Bit for bit over two steps: the copy is the eager step with the
    plain banded remap formula, which the port's eager step runs on the
    CPU."""
    cell = small_cell(name)
    model = _program(cell, fused=False)
    ref = cell.model.build_reference(cell.config, "cpu")
    s = cell.model.initial_state(model, cell.traffic, 5)
    r = cell.model.reference_initial(ref, cell.traffic, 5)
    for _ in range(3):
        for f in dataclasses.fields(s):
            assert torch.equal(getattr(s, f.name), getattr(r, f.name)), f.name
        s, r = model.step(s), ref.step(r)


@pytest.mark.parametrize("name", CELLS)
def test_fused_step_within_the_limit(name):
    """The fused step (the kernels' plain versions on the CPU) against the
    reference stepped from the same state, by the check's own number."""
    cell = small_cell(name)
    fields = cell.model.compared_fields(cell.config)
    model = _program(cell, fused=True)
    ref = cell.model.build_reference(cell.config, "cpu")
    s = cell.model.initial_state(model, cell.traffic, 9)
    for _ in range(3):
        out = model.step(s)
        gaps = compare.step_gaps(ref, s, out, fields)
        assert max(gaps.values()) <= compare.STEP_GAP_LIMIT, gaps
        s = out

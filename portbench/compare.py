"""The check that decides `correct`: the plain reference
(portbench/reference/), stepped from the program's own state, against the
program's output of that step.

The model's state evolves, so the reference follows the program step by
step: for each compared step it takes the state the program stepped
from, runs its own step (its own grid, metrics and context, built from
the same configuration file; plain PyTorch, TF32 off) and compares the
program's output field by field.  The start is checked by itself: the
reference draws the initial state from the seed as the program's init
does and must find the program's initial state exactly (limit 0).  The
cell's model file (portbench/models/) builds both sides, draws both
initial states and names the compared fields; the limits below are every
model's.

A step's number is its worst field's gap, max |program - reference| over max
|reference - input|: the error as a share of the largest change the step
made to that field, where that change is at least CHANGE_FLOOR of the
field's largest value (a field that a step hardly moves, such as a tracer in
a flow at rest, is judged against 1e-4 of its size, the repository's own
relative gate, and not against its rounding).  A program that returns its
input unchanged reads 1 in every field that the step moves by more.  The
limit (`STEP_GAP_LIMIT`) was set from the program's readings over a dozen
seeds and more and the control's on the card at the cells' sizes: PERF.md
gives both readings.  The control is the reference in the program's place
with TF32 on, the nearest precision below the configuration's float32 with
TF32 off.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

STEP_GAP_LIMIT = 0.1
CHANGE_FLOOR = 1e-4
START_LIMIT = 0.0

@contextlib.contextmanager
def plain_f32():
    """TF32 off for the reference's block, as the configuration states."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def as_reference_state(state):
    """The program's state as the reference's state type (the same
    tensors)."""
    from .reference.core.state import DycoreState

    return DycoreState(**{f.name: getattr(state, f.name)
                          for f in dataclasses.fields(DycoreState)})


def start_gap(ref_initial, program_initial, fields) -> float:
    """max |program - reference| of the initial state over `fields`."""
    return max(float((getattr(ref_initial, f) - getattr(program_initial, f))
                     .abs().max()) for f in fields)


def compared_steps(first: dict, window: dict) -> list:
    """[(name, (input, output))]: the first step (held by the warm-up) and
    the window's held steps, in order."""
    return [("first_step", first[0])] + [
        (f"window_step_{k}", window[k]) for k in sorted(window)]


def gap_table(ref, ref_initial, steps: list, fields) -> dict:
    """The readings of one run: the start's gap against the reference's
    own initial state `ref_initial`, and each compared step's gaps by field
    ({name: {field: gap}}).  `steps` as compared_steps gives them; the
    first one's input is the program's initial state."""
    table = {"start_max_abs": start_gap(ref_initial, steps[0][1][0],
                                        fields)}
    for name, (inp, out) in steps:
        table[name] = step_gaps(ref, inp, out, fields)
    return table


def checks(table: dict, final_finite: bool) -> dict:
    """{name: [value, limit]}: the numbers that decide `correct`, each
    beside its limit; a step's number is its worst field's gap."""
    out = {}
    for name, v in table.items():
        out[name if name == "start_max_abs" else f"{name}_gap"] = (
            [max(v.values()), STEP_GAP_LIMIT] if isinstance(v, dict)
            else [v, START_LIMIT])
    out["final_state_finite"] = [int(final_finite), 1]
    return out


def failed(numbers: dict) -> int:
    """How many of `numbers` (as `checks` gives them) miss their limit (a
    finite state has to read its limit; a gap may not pass it)."""
    return sum(1 for k, (v, lim) in numbers.items()
               if (v < lim if k == "final_state_finite" else not v <= lim))


def field_gaps(inp, out, ref_out, fields) -> dict:
    """{field: max |out - ref_out| / max(max |ref_out - inp|, CHANGE_FLOOR
    * max |ref_out|)}; inf where `out` is not finite."""
    gaps = {}
    for f in fields:
        r = getattr(ref_out, f)
        scale = max(float((r - getattr(inp, f)).abs().max()),
                    CHANGE_FLOOR * float(r.abs().max()))
        err = float((getattr(out, f) - r).abs().max())
        if err != err or scale == 0.0:  # NaN, or a field that is all zeros
            gaps[f] = 0.0 if err == 0.0 else float("inf")
        else:
            gaps[f] = err / scale
    return gaps


def step_gaps(ref, inp, out, fields) -> dict:
    """The reference's step from the program's input `inp`, against the
    program's output `out`."""
    with torch.no_grad(), plain_f32():
        ref_out = ref.step(as_reference_state(inp))
    return field_gaps(inp, out, ref_out, fields)


def to_bf16(state):
    """The state stored in bfloat16 (and read back as float32)."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(torch.bfloat16).to(torch.float32)
        for f in dataclasses.fields(state)})


@contextlib.contextmanager
def tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def control_gaps(ref, inp, fields, kind: str = "tf32") -> dict:
    """A control: the reference in the program's place in a precision
    below the configuration's, against the reference in float32 with TF32
    off.  "tf32": the nearest below, TF32 on (the chart corners' batched
    products run in it); "bf16": the state stored in bfloat16."""
    with torch.no_grad(), plain_f32():
        ref_out = ref.step(as_reference_state(inp))
        if kind == "tf32":
            with tf32():
                low = ref.step(as_reference_state(inp))
        elif kind == "bf16":
            low = to_bf16(ref.step(as_reference_state(to_bf16(inp))))
        else:
            raise ValueError(f"no control {kind!r}")
    return field_gaps(inp, low, ref_out, fields)

"""The one traffic generator: a free-running model, stepped as a climate run
steps it, from a state drawn from the seed.

A traffic file (`portbench/traffic/<name>.json`) gives:

* `in_flight`: the steps the host keeps queued; before it issues step i it
  waits on the end event of step i - in_flight;
* `warmup_steps`: steps run the same way before the window, in set-up;
* `pick_steps`: the two window steps that the check compares are drawn
  from the seed among the window's first `pick_steps` steps;
* `trace_steps`: the steps a `--trace 1` run traces after its window;
* what the cell's model file (portbench/models/) reads to draw the
  initial state, such as `perturb` and `tracer_max`.

The program is entered only through what the model file builds: an
object with `device` and `step(state)`.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

SEED_MOD = 2 ** 63


def seed_of(seed: int) -> int:
    """The seed as numpy's and torch's generators take it (non-negative)."""
    return int(seed) % SEED_MOD


def picks(traffic: dict, seed: int) -> list:
    """The two window steps the check compares, drawn from the seed."""
    rng = np.random.default_rng(seed_of(seed))
    return sorted(int(k) for k in rng.choice(traffic["pick_steps"], 2,
                                              replace=False))


def clone_state(state):
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)})


def _allocated(device) -> int:
    """The device memory allocated now (0 off a card); a host-side count,
    with no sync."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.memory_allocated(device)


class _Stamps:
    """End-of-step stamps: CUDA events recorded on the stream (no host
    sync) on a card, the host clock after each step on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i: int):
        if self.cuda:
            self.marks[i].synchronize()

    def seconds(self, i: int, j: int) -> float:
        if self.cuda:
            return self.marks[i].elapsed_time(self.marks[j]) / 1e3
        return self.marks[j] - self.marks[i]


@dataclass
class Window:
    steps: int = 0
    window_s: float = 0.0
    intervals_s: list = field(default_factory=list)
    issue_s: list = field(default_factory=list)   # host seconds in each step
    # {step index: (input state, output state)}, cloned on the stream
    held: dict = field(default_factory=dict)
    held_bytes: int = 0   # the device memory that `held` takes
    state: object = None


def free_run(model, state, traffic: dict, seconds: float = None,
             steps: int = None, hold=()) -> Window:
    """Step `state` free-running until `seconds` have passed on the host
    clock (and every step in `hold` is done) or for `steps` steps.  The
    window runs from a stamp before the first step to the end stamp of the
    last; `intervals_s` are the times between consecutive stamps, `issue_s`
    the host's time inside each `model.step` call (its issue time).  The
    input and output of each step in `hold` are cloned on the stream,
    before and after that step, so that what the timed path produced is
    kept whatever later steps do with their buffers."""
    in_flight = traffic["in_flight"]
    stamps = _Stamps(model.device)
    out = Window()
    last_hold = max(hold, default=-1)
    stamps.mark()
    t0 = time.perf_counter()
    i = 0
    while True:
        if steps is not None:
            if i >= steps:
                break
        elif time.perf_counter() - t0 >= seconds and i > last_hold:
            break
        if i >= in_flight:
            stamps.wait(i - in_flight + 1)   # the end of step i - in_flight
        if i in hold:
            a = _allocated(model.device)
            before = clone_state(state)
            out.held_bytes += _allocated(model.device) - a
        t = time.perf_counter()
        state = model.step(state)
        out.issue_s.append(time.perf_counter() - t)
        if i in hold:
            a = _allocated(model.device)
            out.held[i] = (before, clone_state(state))
            out.held_bytes += _allocated(model.device) - a
        stamps.mark()
        i += 1
    stamps.wait(i)
    out.steps = i
    out.window_s = stamps.seconds(0, i)
    out.intervals_s = [stamps.seconds(j, j + 1) for j in range(i)]
    out.state = state
    return out

"""Spans: named host intervals at the port's layer boundaries.

    from geosongpu_tpu_torch import spans

    with spans.recording() as records:
        model.step(state)
    # records: [SpanRecord(name, start_ns, end_ns, parent, step), ...]

`span(name)` is a context manager around one layer's host work;
`spanned(name)` the same as a decorator, for the kernel wrappers and the
fill methods.  Names are dotted: `step`, `substep`, `halo.fill`,
`exchange.permute`, `kernel.dsw_csw1`, `setup.grid`, ...  A span named
`step` that opens outside any other `step` starts a model step: it and
every span inside it carry that step's index (0, 1, ... within one
recording); a span outside any step carries -1.

Recording is off unless a `recording()` block is open.  Off, `span`
returns one shared object whose enter and exit do nothing: no allocation,
no clock read, no torch call.  On, each span reads the clock twice and
writes one record into a list preallocated by `recording`; nothing is
written anywhere else until the block ends.

The clock is `time.time_ns()`, nanoseconds since the epoch: the clock of
torch.profiler's host events, whose Chrome trace gives each event's `ts`
in microseconds after its `baseTimeNanoseconds` (portbench/spans.py maps
one onto the other; tests/test_torch_spans.py holds the two together).
Records belong to the thread that opens the spans: the port steps on one.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Iterator, List, NamedTuple

_now = time.time_ns


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int    # index of the enclosing span's record, -1 at the root
    step: int      # index of the enclosing `step` span, -1 outside any


class _Off:
    """The shared span of a process that is not recording.  Its enter and
    exit are C functions, which the `with` statement calls without the
    object: `"".format` takes any arguments and returns "", which is false,
    so an exception passes through.  A Python method would double the
    cost of an idle span site."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _Recorder:
    """The records of one `recording()` block: [name, start, end, parent,
    step] rows in a preallocated list, and the stack of open spans."""

    def __init__(self, capacity: int):
        self.rows = [None] * capacity
        self.n = 0
        self.open = []
        self.step = -1
        self.steps = 0

    def enter(self, name: str) -> int:
        step = self.step
        if name == "step" and step < 0:
            step = self.step = self.steps
            self.steps += 1
        i = self.n
        if i == len(self.rows):
            self.rows.extend([None] * len(self.rows))
        self.rows[i] = [name, 0, 0, self.open[-1] if self.open else -1, step]
        self.n = i + 1
        self.open.append(i)
        self.rows[i][1] = _now()
        return i

    def exit(self, i: int) -> None:
        row = self.rows[i]
        row[2] = _now()
        self.open.pop()
        if row[0] == "step" and (row[3] < 0 or self.rows[row[3]][4] < 0):
            self.step = -1

    def records(self) -> List[SpanRecord]:
        return [SpanRecord(*row) for row in self.rows[:self.n]]


_active = None   # the open recording's _Recorder, or None


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec.enter(self.name)

    def __exit__(self, *exc):
        self.rec.exit(self.i)
        return False


def span(name: str):
    """A context manager that records `name` around its block while a
    recording is open, and does nothing otherwise."""
    rec = _active
    if rec is None:
        return _OFF
    return _Span(rec, name)


def spanned(name: str):
    """Decorator: the function's every call inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _active
            if rec is None:
                return fn(*args, **kwargs)
            i = rec.enter(name)
            try:
                return fn(*args, **kwargs)
            finally:
                rec.exit(i)
        return call
    return wrap


@contextlib.contextmanager
def recording(capacity: int = 1 << 14) -> Iterator[List[SpanRecord]]:
    """Record every span opened inside the block.  Yields a list that
    holds the block's SpanRecords, in the order the spans opened, once the
    block has ended.  Recordings do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a span recording is already open")
    rec = _Recorder(capacity)
    out: List[SpanRecord] = []
    _active = rec
    try:
        yield out
    finally:
        _active = None
        out.extend(rec.records())

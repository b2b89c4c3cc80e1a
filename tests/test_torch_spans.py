"""The program's span recorder (geosongpu_tpu_torch/spans.py) on the CPU.

- Off, a span site (a `with span(...)` block or a decorated call)
  records nothing and allocates nothing: every `span` is one shared
  object.
- On, the recorder's tree: parents, step ids, a span closed by an
  exception, recordings that do not nest, a list that outgrows its
  preallocation.
- One small Held-Suarez step on the fused path and one nonhydrostatic
  step give the expected span tree: one root `step` per step, one
  `substep` per acoustic substep, one `kernel.*` span per kernel wrapper
  call (the calls the card's `launches` counters count; the A-grid
  kernel's inside `agrid`), the fills inside the substeps; the states
  are bit-identical with recording on and off.
- The stacked step of the subtile tests records the fills with their
  exchange rounds (`exchange.permute`) inside.
- The clock: under torch.profiler with CPU activity, an aten op issued
  inside a span has its trace `ts`, mapped by portbench/spans.py's rule,
  inside that span.
"""
import collections
import dataclasses
import itertools
import json
import tracemalloc

import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu_torch import spans  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.parallel import subtile  # noqa: E402
from portbench.spans import on_trace_clock  # noqa: E402

CPU = torch.device("cpu")
HS = dict(npx=8, npz=6, dt=1200.0, n_split=2, hord_tm=6, ntracers=1,
          pallas_dycore=True)
NH = dict(HS, hydrostatic=False, z_tracer=False)
DSW = ("kernel.dsw_csw1", "kernel.dsw_csw2", "kernel.dsw_transport",
       "kernel.dsw_wind", "kernel.agrid_winds")


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return {k: build_model(DycoreConfig(**kw), CPU)
            for k, kw in (("hs", HS), ("nh", NH))}


def _names(records, parent):
    return [r.name for r in records if r.parent == parent]


def _peak_bytes(body) -> int:
    """The most memory body(n) holds above its start, at n = 1000, after a
    warm call."""
    body(10)
    tracemalloc.reset_peak()
    start, _ = tracemalloc.get_traced_memory()
    body(1000)
    return tracemalloc.get_traced_memory()[1] - start


def test_off_records_nothing_and_allocates_nothing():
    assert spans.span("a") is spans.span("halo.fill")
    with pytest.raises(ValueError):
        with spans.span("a"):
            raise ValueError
    f = spans.spanned("kernel.f")(lambda x: x + 1)

    def empty(n):
        for _ in itertools.repeat(None, n):
            pass

    def sites(n):
        for _ in itertools.repeat(None, n):
            with spans.span("halo.fill"):
                f(1)

    tracemalloc.start()
    try:
        assert _peak_bytes(sites) <= _peak_bytes(empty)
    finally:
        tracemalloc.stop()
    with spans.recording() as records:
        pass
    assert records == []


def test_the_recorder_tree():
    f = spans.spanned("kernel.f")(lambda x: x + 1)
    with spans.recording(capacity=2) as records:
        with spans.span("setup.grid"):
            pass
        for _ in range(2):
            with spans.span("step"):
                with spans.span("step"):     # inside a step: the same id
                    assert f(1) == 2
        with pytest.raises(ValueError):
            with spans.span("halo.fill"):
                raise ValueError
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert spans.span("a") is spans.span("b")   # off again
    assert [(r.name, r.parent, r.step) for r in records] == [
        ("setup.grid", -1, -1),
        ("step", -1, 0), ("step", 1, 0), ("kernel.f", 2, 0),
        ("step", -1, 1), ("step", 4, 1), ("kernel.f", 5, 1),
        ("halo.fill", -1, -1)]
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = records[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def _record(model, state, steps=1):
    with spans.recording() as records:
        for _ in range(steps):
            state = model.step(state)
    return state, records


def _check_tree(records, cfg, steps):
    count = collections.Counter((r.name, r.step) for r in records)
    roots = [r for r in records if r.parent == -1]
    assert [(r.name, r.step) for r in roots] == [
        ("step", k) for k in range(steps)]
    assert {r.step for r in records} == set(range(steps))
    for k, root in enumerate(roots):
        i = records.index(root)
        assert _names(records, i) == ["dynamics", "forcing", "symmetrize"]
        dyn = records.index(next(r for r in records
                                 if r.name == "dynamics" and r.step == k))
        subs = [n for n in _names(records, dyn)]
        assert subs.count("substep") == cfg.n_split
        for name in DSW:
            assert count[(name, k)] == cfg.n_split, name
        assert count[("kernel.remap_banded", k)] == 3
        assert count[("halo.symmetrize", k)] == 1
    for r in records:
        chain, p = [], r.parent
        while p >= 0:
            chain.append(records[p].name)
            p = records[p].parent
        if r.name in DSW + ("kernel.dsw_tracer", "kernel.nh_vertical_solve",
                            "agrid"):
            assert "substep" in chain, (r.name, chain)
        if r.name == "kernel.remap_banded":
            assert chain[0] == "remap"
        if r.name == "kernel.agrid_winds":
            assert chain[0] == "agrid"
        if r.name.startswith("halo.fill"):
            assert chain[0] in ("substep", "tracer_acc", "remap",
                                "damping_divergence"), chain
    return count


def test_hydrostatic_step_tree_and_bits(models):
    model = models["hs"]
    state = model.init(perturb=1.0)
    ref = model.step(model.step(state))
    got, records = _record(model, state, steps=2)
    cfg = model.config
    count = _check_tree(records, cfg, 2)
    for k in range(2):
        assert count[("kernel.dsw_tracer_acc", k)] == cfg.q_split
        assert count[("kernel.nh_vertical_solve", k)] == 0
        assert count[("tracer_acc", k)] == cfg.n_split + 1
        assert count[("agrid", k)] == count[("chart.agrid", k)] == 2
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name


def test_nonhydrostatic_step_tree_and_bits(models):
    model = models["nh"]
    state = model.init(perturb=1.0)
    ref = model.step(state)
    got, records = _record(model, state)
    cfg = model.config
    count = _check_tree(records, cfg, 1)
    assert count[("kernel.nh_vertical_solve", 0)] == cfg.n_split
    assert count[("kernel.dsw_tracer", 0)] == cfg.n_split * cfg.ntracers
    assert count[("kernel.dsw_tracer_acc", 0)] == 0
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name


def test_stacked_step_records_the_exchange():
    cfg = DycoreConfig(npx=8, npz=4, dt=600.0, n_split=1, halo=3,
                       pallas_dycore=True)
    model = build_model(cfg, CPU)
    lay = subtile.SubtileLayout(n=8, h=3, py=1, px=1, face_sharded=True)
    step, place, unplace = subtile.build_subtile_step(
        model.ctx, lay, lats=model.lats, forcing=model.forcing)
    state = place(model.init(perturb=1e-3))
    ref = step(state)
    got, records = _record(type("M", (), {"step": staticmethod(step)}),
                           state)
    assert [r.name for r in records if r.parent == -1] == ["step"]
    permutes = [r for r in records if r.name == "exchange.permute"]
    assert permutes
    for r in permutes:
        assert records[r.parent].name in ("halo.fill", "halo.fill_dgrid",
                                          "halo.fill_cgrid",
                                          "halo.symmetrize")
    parents = {records[r.parent].name for r in permutes}
    assert {"halo.fill", "halo.fill_dgrid", "halo.symmetrize"} <= parents
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name


def test_an_aten_op_in_a_span_lies_inside_it_on_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as records:
            with spans.span("probe"):
                torch.mm(x, x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    (probe,) = on_trace_clock(records, int(trace["baseTimeNanoseconds"]))
    (mm,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert probe.start <= mm["ts"] <= mm["ts"] + mm["dur"] <= probe.end


def _wrappers():
    from geosongpu_tpu_torch.ops.kernels import _wrappers as every
    from geosongpu_tpu_torch.ops.kernels.columns import fill_q2_zero_tracers

    return list(every()) + [fill_q2_zero_tracers]


@pytest.mark.parametrize("index", range(20))
def test_each_kernel_wrapper_is_its_kernel_span(index):
    """Every wrapper with a `launches` counter runs inside the span
    `kernel.<name>` (fill_q2_zero_tracers counts, and is named, as
    fill_q2_zero), keeps its name and its counter."""
    wrappers = _wrappers()
    assert len(wrappers) == 20
    w = wrappers[index]
    counted = "fill_q2_zero" if w.__name__ == "fill_q2_zero_tracers" \
        else w.__name__
    assert isinstance(getattr(w, "launches", None), int) or \
        w.__name__ == "fill_q2_zero_tracers"
    with spans.recording() as records:
        with pytest.raises(TypeError):
            w()
    assert [(r.name, r.parent) for r in records] == [
        (f"kernel.{counted}", -1)]


def test_annotation_is_a_span_and_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    from geosongpu_tpu_torch.benchmark.profiler import annotation

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as records:
            with annotation("phase"):
                torch.ones(4).sum()
    assert [r.name for r in records] == ["phase"]
    assert any(e.name == "phase" for e in prof.events())

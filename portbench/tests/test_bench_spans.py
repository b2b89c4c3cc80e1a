"""The span readers (portbench/spans.py) on a synthetic Chrome trace with
known answers: each device event put down to the innermost span open at
its runtime call, the idle gaps split over the spans the host was in, self
times, the wrapper + halo + glue partition of the `step` spans, the
launch match, and every span metric reading nothing when the spans do not
line up with the trace's clock or when the program recorded none; and
the traced branch of portbench/run.py at a small size on the CPU, which
hands the readers the program's spans."""
import json
import sys

import pytest

from portbench import devtrace, spans, spec
from pbhelpers import load_run, small_cell

BASE = 1_790_000_000_000_000_000   # the trace's baseTimeNanoseconds
STEPS = 2
# (name, start us, end us, parent, step) on the trace's clock
SPANS = [
    ("step", 0, 100, -1, 0),                   # 0
    ("substep", 5, 60, 0, 0),                  # 1
    ("halo.fill", 6, 16, 1, 0),                # 2
    ("exchange.permute", 8, 12, 2, 0),         # 3
    ("kernel.dsw_csw1", 20, 30, 1, 0),         # 4
    ("kernel.dsw_transport", 32, 38, 1, 0),    # 5
    ("remap", 65, 90, 0, 0),                   # 6
    ("kernel.remap_banded", 70, 80, 6, 0),     # 7
    ("step", 120, 200, -1, 1),                 # 8
    ("halo.fill", 128, 135, 8, 1),             # 9
    ("kernel.dsw_csw1", 150, 158, 8, 1),       # 10
]
# (runtime call, host ts, device event name, category, device ts, dur)
LAUNCHES = [
    ("cudaLaunchKernel", 9, "void at::native::vectorized_gather_kernel()",
     "kernel", 110, 2),
    ("cudaLaunchKernel", 14, "void at::native::elementwise_kernel<mul>()",
     "kernel", 112, 3),
    ("cuLaunchKernel", 22, "void dsw::csw1(Metrics)", "kernel", 115, 10),
    ("cuLaunchKernel", 33, "void dsw::fvtp2d_tile<2>(Metrics)", "kernel",
     125, 2),
    ("cuLaunchKernel", 34, "void dsw::transport_update(Metrics)", "kernel",
     127, 2),
    ("cudaLaunchKernel", 40, "void at::native::elementwise_kernel<add>()",
     "kernel", 140, 4),
    ("cudaLaunchKernel", 66, "void at::native::tensor_kernel_scan<double>()",
     "kernel", 144, 6),
    ("cudaLaunchKernelExC", 72, "void remap::remap_banded_kernel(float*)",
     "kernel", 150, 6),
    ("cudaMemcpyAsync", 95, "Memcpy DtoD (Device -> Device)", "gpu_memcpy",
     160, 2),
    ("cudaLaunchKernel", 105, "void foo()", "kernel", 163, 1),
    ("cuLaunchKernel", 152, "void dsw::csw1(Metrics)", "kernel", 170, 5),
    ("cudaLaunchKernel", 101, "void bar()", "kernel", 205, 1),
]
NEW = tuple(spans.LAYER_METRICS)


def _trace(tmp_path):
    ev = []
    for c, (call, ts, name, cat, dts, dur) in enumerate(LAUNCHES):
        ev.append({"ph": "X", "cat": "cuda_driver" if call.startswith("cuL")
                   else "cuda_runtime", "name": call, "ts": ts, "dur": 0.5,
                   "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": dts,
                   "dur": dur, "args": {"correlation": c}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name":
               "cudaStreamSynchronize", "ts": 99, "dur": 1,
               "args": {"correlation": 99}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE,
                                "traceEvents": ev}))
    return str(path)


def _record(tmp_path, shift_us=0.0, spans_given=True):
    """A TraceRecord of the synthetic trace, its spans read as the program
    records them (ns since the epoch) and shifted by shift_us."""
    path = _trace(tmp_path)
    events = devtrace.read_trace(path)
    base, calls = spans.read_calls(path, events)
    assert base == BASE
    records = [(n, BASE + int((s + shift_us) * 1000),
                BASE + int((e + shift_us) * 1000), p, k)
               for n, s, e, p, k in SPANS] if spans_given else []
    b = devtrace.busy(events)
    return load_run().TraceRecord(
        events=events, steps=STEPS, busy_s=b["busy_s"], window_s=b["span_s"],
        calls=[], peaks=None, wall_s_per_step=1e-4, issue_s=[1e-4],
        spans=spans.on_trace_clock(records, base), runtime_calls=calls)


def _read(name, rec):
    """The metric `name` of the record, by its reader file."""
    return spec.reader("metrics", name).read(rec)


def test_calls_carry_the_events_they_launched(tmp_path):
    rec = _record(tmp_path)
    by_ts = {c.ts: c for c in rec.runtime_calls}
    assert len(rec.runtime_calls) == len(LAUNCHES) + 1
    assert by_ts[99].events == ()
    for call, ts, name, *_ in LAUNCHES:
        (i,) = by_ts[ts].events
        assert rec.events[i].name == name and by_ts[ts].name == call
    assert rec.spans[4] == spans.Span("kernel.dsw_csw1", 20.0, 30.0, 1, 0)


def test_device_time_goes_to_the_innermost_span(tmp_path):
    by = spans.analyse(_record(tmp_path))["by_span"]
    per_step = lambda us: us / 1e3 / STEPS
    self_dev = {n: v.get("device_self_ms", 0.0) for n, v in by.items()}
    assert self_dev == pytest.approx({
        "exchange.permute": per_step(2), "halo.fill": per_step(3),
        "kernel.dsw_csw1": per_step(15), "kernel.dsw_transport": per_step(4),
        "substep": per_step(4), "remap": per_step(6),
        "kernel.remap_banded": per_step(6), "step": per_step(2),
        spans.OUTSIDE: per_step(2)})
    # inclusive: a span's own and its children's
    assert by["step"]["device_ms"] == pytest.approx(per_step(42))
    assert by["halo.fill"]["device_ms"] == pytest.approx(per_step(5))
    assert by["kernel.dsw_csw1"]["launches"] == 1.0
    assert by[spans.OUTSIDE]["launches"] == 1.0
    # the dsw wrappers' span device time equals the stage grouping's
    dsw = sum(v.get("device_ms", 0.0) for n, v in by.items()
              if n.startswith("kernel.dsw_"))
    assert dsw == pytest.approx(_read("dsw_device_ms", _record(tmp_path)))


def test_self_time_and_the_step_partition(tmp_path):
    rec = _record(tmp_path)
    by = spans.analyse(rec)["by_span"]
    self_us = {"step": 20 + 65, "substep": 29, "halo.fill": 6 + 7,
               "exchange.permute": 4, "kernel.dsw_csw1": 18,
               "kernel.dsw_transport": 6, "remap": 15,
               "kernel.remap_banded": 10}
    for n, us in self_us.items():
        assert by[n]["host_self_ms"] == pytest.approx(us / 1e3 / STEPS), n
    assert by["step"]["host_ms"] == pytest.approx(180 / 1e3 / STEPS)
    assert by["substep"]["host_ms"] == pytest.approx(55 / 1e3 / STEPS)
    wrapper, halo, glue = (_read(n, rec) for n in (
        "wrapper_host_ms", "halo_host_ms", "glue_host_ms"))
    assert wrapper == pytest.approx(34 / 1e3 / STEPS)
    assert halo == pytest.approx(17 / 1e3 / STEPS)
    assert glue == pytest.approx(129 / 1e3 / STEPS)
    assert wrapper + halo + glue == pytest.approx(by["step"]["host_ms"])
    assert _read("halo_device_ms", rec) == pytest.approx(5 / 1e3 / STEPS)
    assert _read("remap_layer_device_ms", rec) == pytest.approx(
        12 / 1e3 / STEPS)


def test_idle_gaps_split_over_the_host_spans(tmp_path):
    a = spans.analyse(_record(tmp_path))
    # gaps [129,140) [156,160) [162,163) [164,170) [175,205)
    assert dict(a["idle_by_span"]) == pytest.approx({
        "halo.fill": 6e-6, "kernel.dsw_csw1": 2e-6,
        "step": (5 + 2 + 1 + 6 + 25) * 1e-6, spans.OUTSIDE: 5e-6})
    assert a["idle_by_span"][0][0] == "step"
    assert a["span_launch_match"] == 1.0


def test_every_span_metric_reads_nothing_off_the_clock(tmp_path):
    aligned = _record(tmp_path)
    assert all(_read(n, aligned) is not None for n in NEW)
    for shift in (50.0, 5.0):
        rec = _record(tmp_path, shift_us=shift)
        assert spans.analyse(rec)["span_launch_match"] < spans.MATCH_MIN
        for n in NEW:
            assert _read(n, rec) is None, (n, shift)
        # the readers from outside the program are untouched
        assert _read("dsw_device_ms", rec) == _read("dsw_device_ms", aligned)


def test_a_program_without_spans(tmp_path, monkeypatch):
    rec = _record(tmp_path, spans_given=False)
    for n in NEW:
        assert _read(n, rec) is None
    assert spans.breakdown(spans.analyse(rec), []) == {}
    import geosongpu_tpu_torch

    monkeypatch.delattr(geosongpu_tpu_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "geosongpu_tpu_torch.spans", None)
    with spans.recording() as records:
        pass
    assert records == []


def test_breakdown_keys(tmp_path):
    rec = _record(tmp_path)
    setup = [("setup.grid", 0, 2_000_000_000, -1, -1),
             ("setup.context", 2_000_000_000, 5_000_000_000, -1, -1),
             ("setup.library", 3_000_000_000, 3_500_000_000, 1, -1)]
    b = spans.breakdown(spans.analyse(rec), setup)
    assert set(b) == {"by_span", "idle_by_span", "setup_by_span",
                      "span_launch_match"}
    assert b["setup_by_span"] == pytest.approx(
        {"setup.grid": 2.0, "setup.context": 3.0, "setup.library": 0.5})
    json.dumps(b)


def test_the_traced_run_hands_the_readers_the_programs_spans(monkeypatch):
    """run.py's traced branch at c8 on the CPU: the per-layer readers get
    the program's spans of the traced steps, and the result's breakdown
    carries the spans' readings beside the trace's.  The CPU's trace holds
    no device event and no runtime call, so no launch is matched and the
    span metrics read nothing; an untraced run records no span."""
    cell = small_cell("hs_c192_l72.free", npx=8, npz=6)
    cell.traffic.update(warmup_steps=1, trace_steps=2)
    seen, opened = [], []
    read_metrics, recording = spec.read_metrics, spans.recording

    def spy(entries, kind, rec, root):
        seen.append(rec)
        return read_metrics(entries, kind, rec, root)

    def counted():
        opened.append(1)
        return recording()

    monkeypatch.setattr(spec, "read_metrics", spy)
    monkeypatch.setattr(spans, "recording", counted)
    run = load_run()
    out = run.run(cell, 2 ** 31 + 11, 0.05, True, "cpu")
    assert out["correct"], out["checks"]
    (rec,) = seen
    assert len(opened) == 2   # around the build and the traced steps
    assert rec.runtime_calls == [] and rec.events == []
    names = {s.name for s in rec.spans}
    assert {"step", "substep", "remap", "halo.fill",
            "kernel.dsw_csw1"} <= names
    assert not any(n.startswith("setup.") for n in names)
    assert sorted({s.step for s in rec.spans}) == [0, 1]
    a = spans.analyse(rec)
    b = out["breakdown"]
    assert b["by_span"] == a["by_span"] and b["by_span"]["step"]["host_ms"] > 0
    assert b["span_launch_match"] is None
    assert {"setup.grid", "setup.vertical", "setup.context"} <= set(
        b["setup_by_span"])
    assert {"device_ops", "idle_gaps"} <= set(b)
    assert not set(spans.LAYER_METRICS) & set(out["metrics"])
    json.dumps(out)
    off = run.run(cell, 7, 0.05, False, "cpu")
    assert off["correct"] and "breakdown" not in off
    assert len(opened) == 2

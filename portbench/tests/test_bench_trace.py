"""The trace's reduction and the per-layer readers on a small synthetic
Chrome trace: the busy union, the stage grouping, the glue remainder, the
idle gaps by the runtime call that ends them."""
import json

import pytest

from portbench import counts, devtrace, spec

# two steps' worth of one stage chain: (ts, dur, name, cat, correlation)
_DEVICE = [
    (0, 10, "void dsw::fvtp2d_tile<2>(Metrics)", "kernel", 1),
    (10, 5, "void dsw::transport_update(Metrics)", "kernel", 1),
    (12, 4, "void at::native::elementwise_kernel<add>()", "kernel", 2),
    (20, 6, "void dsw::csw1(Metrics)", "kernel", 3),
    (30, 2, "Memcpy DtoD (Device -> Device)", "gpu_memcpy", 4),
    (40, 8, "void remap::remap_banded_kernel(float*)", "kernel", 5),
    (50, 3, "void nh::nh_vertical_columns(float*)", "kernel", 6),
]
_CALLS = {1: "cudaLaunchKernel", 2: "cudaLaunchKernel", 3: "cuLaunchKernel",
          4: "cudaMemcpyAsync", 5: "cudaLaunchKernelExC", 6: "cuLaunchKernel"}


def _events(tmp_path):
    ev = [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
           "args": {"correlation": c}}
          for ts, dur, name, cat, c in _DEVICE]
    ev += [{"ph": "X", "cat": "cuda_driver" if call.startswith("cu") and
            not call.startswith("cuda") else "cuda_runtime", "name": call,
            "ts": 0, "dur": 1, "args": {"correlation": c}}
           for c, call in _CALLS.items()]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return devtrace.read_trace(str(path))


def test_busy_union_and_span(tmp_path):
    ev = _events(tmp_path)
    b = devtrace.busy(ev)
    # [0, 16] [20, 26] [30, 32] [40, 48] [50, 53]: 16+6+2+8+3 over 53 us
    assert b["busy_s"] == pytest.approx(35e-6)
    assert b["span_s"] == pytest.approx(53e-6)


def test_stage_grouping(tmp_path):
    times = devtrace.wrapper_times(_events(tmp_path))
    assert times == {"dsw_transport": 15.0, "dsw_csw1": 6.0,
                     "remap_banded": 8.0, "nh_vertical_solve": 3.0}
    with pytest.raises(ValueError):
        devtrace.wrapper_times([devtrace.Event(
            0, 1, "void dsw::fvtp2d_tile<1>()", "kernel", "")])


def test_idle_gaps_by_runtime_call(tmp_path):
    gaps = dict(devtrace.idle_gaps(_events(tmp_path)))
    assert gaps == pytest.approx({"before cuLaunchKernel": 4e-6 + 2e-6,
                                  "before cudaMemcpyAsync": 4e-6,
                                  "before cudaLaunchKernelExC": 8e-6})
    top = devtrace.top_ops(_events(tmp_path), n=2)
    assert [n for n, _ in top] == ["void dsw::fvtp2d_tile<2>(Metrics)",
                                   "void remap::remap_banded_kernel(float*)"]


def test_per_layer_readers(tmp_path):
    from pbhelpers import load_run

    run = load_run()
    ev = _events(tmp_path)
    b = devtrace.busy(ev)
    calls = [counts.Call("dsw_transport", "dsw_transport", 3_350, 1),
             counts.Call("dsw_wind", "dsw_wind", 3_350_000, 1),
             counts.Call("nh_vertical_solve", "nh_vertical_solve", 335, 1)]
    peaks = {"hbm_bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12}
    rec = run.TraceRecord(events=ev, steps=2, busy_s=b["busy_s"],
                          window_s=b["span_s"], calls=calls, peaks=peaks,
                          wall_s_per_step=1e-5, issue_s=[0.002, 0.004])
    read = lambda name: spec.reader("metrics", name).read(rec)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 35 / 53))
    # glue: the add kernel and the copy, 6 us over two steps
    assert read("glue_device_ms") == pytest.approx(0.003)
    assert read("device_launches_per_step") == 3.0
    assert read("host_issue_ms") == pytest.approx(3.0)
    # the dsw launches found: transport and csw1, 21 us over two steps
    assert read("dsw_device_ms") == pytest.approx(0.0105)
    # only dsw_transport's count has a stage in the trace (dsw_wind has
    # none): 1 ns a step over 10.5 us
    assert read("dsw_roofline") == pytest.approx(100 * 1e-9 / 10.5e-6)
    assert read("remap_device_ms") == pytest.approx(0.004)
    assert read("nh_solve_device_ms") == pytest.approx(0.0015)
    assert read("nh_vertical_solve_roofline") == pytest.approx(
        100 * 0.1e-9 / 1.5e-6)
    # the step's least time: the larger of 3,353,685 bytes and 1,245
    # operations a step, over 10 us of wall a step
    assert read("mfu_step_pct") == pytest.approx(
        100 * (3_353_685 / 3.35e12) / 1e-5)


def test_readers_find_nothing_in_an_empty_trace():
    from pbhelpers import load_run

    rec = load_run().TraceRecord(events=[], steps=2, busy_s=0.0,
                                 window_s=0.0, calls=[], peaks=None,
                                 wall_s_per_step=0.0, issue_s=[])
    for name in ("device_idle_pct", "glue_device_ms", "dsw_device_ms",
                 "dsw_roofline", "remap_device_ms", "nh_solve_device_ms",
                 "nh_vertical_solve_roofline", "mfu_step_pct",
                 "device_launches_per_step", "host_issue_ms"):
        assert spec.reader("metrics", name).read(rec) is None, name


def test_an_event_without_its_call_names_its_gap(tmp_path):
    """A gap whose ending event has no runtime call in the trace is named
    by that event."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 2,
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 5,
           "dur": 1, "args": {}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
           "ts": 4, "dur": 1, "args": {"correlation": 8}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    gaps = devtrace.idle_gaps(devtrace.read_trace(str(path)))
    assert gaps == [["before Memcpy HtoD", pytest.approx(3e-6)]]

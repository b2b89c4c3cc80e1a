"""The aquaplanet cell: found by name, its two initial states equal to the
bit, cloud and rain from the first step, and a traced CPU run of it at
c12-L8 correct, whose spans the three new readers read once device
events are put into them (the CPU's trace holds none)."""
import dataclasses

import pytest
import torch

from portbench import counts, devtrace, spans, spec
from pbhelpers import load_run, small_cell

CELL = "aq_c180_l72.moist"
NEW = ("physics_device_ms", "moist_columns_device_ms",
       "moist_columns_roofline")
SEED = 2 ** 33 + 17


def test_the_cell_is_found_by_name():
    c = spec.cell(CELL)
    assert c.chips == 1
    d = c.config["dycore"]
    assert (d["npx"], d["npz"], d["ntracers"], d["dt"], d["n_split"]) == (
        180, 72, 3, 300.0, 8)
    assert d["pallas_dycore"] and d["pallas_microphysics"] and \
        d["hydrostatic"]
    assert c.model.__file__.endswith("portbench/models/aquaplanet.py")
    assert (c.traffic["qv_boost"], c.traffic["ql_max"],
            c.traffic["qr_max"]) == (0.9, 3e-4, 1e-4)
    names = [m["name"] for m in c.per_layer]
    assert set(NEW) <= set(names) and "nh_solve_device_ms" not in names
    assert {m["name"] for m in c.end_to_end} == {
        "sypd", "energy_kj_per_sim_day", "setup_s"}
    for other in ("hs_c192_l72.free", "nh_c192_l72.free"):
        assert not set(NEW) & {m["name"] for m in spec.cell(other).per_layer}


@pytest.fixture(scope="module")
def small():
    cell = small_cell(CELL)
    return cell, cell.model.build_program(cell.config, "cpu")


def test_initial_states_equal_to_the_bit(small):
    cell, model = small
    ref = cell.model.build_reference(cell.config, "cpu")
    s = cell.model.initial_state(model, cell.traffic, SEED)
    r = cell.model.reference_initial(ref, cell.traffic, SEED)
    for f in dataclasses.fields(s):
        assert torch.equal(getattr(s, f.name), getattr(r, f.name)), f.name
    other = cell.model.initial_state(model, cell.traffic, SEED + 1)
    assert not torch.equal(other.q, s.q) and not torch.equal(other.pt, s.pt)


def test_cloud_and_rain_from_the_first_step(small):
    cell, model = small
    tr = cell.traffic
    dry = model.init(perturb=tr["perturb"], seed=SEED)
    s = cell.model.initial_state(model, tr, SEED)
    qv, ql, qr = s.q.unbind(-1)
    assert bool((qv >= dry.q[..., 0]).all())
    assert bool((qv < (1.0 + tr["qv_boost"]) * dry.q[..., 0]).all())
    assert 0.0 <= float(ql.min()) and 0.5 * tr["ql_max"] < float(
        ql.max()) < tr["ql_max"]
    assert 0.0 <= float(qr.min()) and 0.5 * tr["qr_max"] < float(
        qr.max()) < tr["qr_max"]
    out = model.step(s)
    assert float(out.q[..., 1].max()) > 1e-4
    assert float(out.q[..., 2].max()) > 1e-5


def test_column_counts_match_the_programs_reckoning(small, monkeypatch):
    """The frozen counts of the chain's three column calls
    (portbench/models/aquaplanet_columns.py) against the program's own
    reckoning (benchmark/bounds.py `moved_bytes` of the tensors each
    wrapper is given and returns, and its OPS_PER_POINT) over one physics
    chain at c12-L8."""
    from geosongpu_tpu_torch.benchmark import bounds
    from geosongpu_tpu_torch.ops.kernels import columns, microphysics
    from portbench.models import aquaplanet_columns

    cell, model = small
    seen = {}

    def record(module, attr, wrapper):
        orig = getattr(module, attr)

        def rec(*args):
            out = orig(*args)
            seen[wrapper] = bounds.moved_bytes(
                [a for a in args if isinstance(a, torch.Tensor)], out)
            return out
        monkeypatch.setattr(module, attr, rec)

    record(columns, "fill_q2_zero_tracers", "fill_q2_zero")
    record(columns, "cup_gf_sh", "cup_gf_sh")
    record(microphysics, "gfdl_microphysics", "gfdl_microphysics")
    model.physics(cell.model.initial_state(model, cell.traffic, SEED))
    calls = aquaplanet_columns.step_calls(cell.config["dycore"])
    assert {k.wrapper: k.bytes for k in calls} == seen
    for k in aquaplanet_columns.OPS_PER_POINT:
        assert aquaplanet_columns.OPS_PER_POINT[k] == bounds.OPS_PER_POINT[k]


def _with_device_events(rec):
    """`rec` with one device event launched in the middle of each span
    named below: a dsw stage in each `kernel.dsw_csw1` (so that the spans
    line up with the trace), a column kernel in each column wrapper's span
    and a plain kernel in `surface_fluxes` and `relaxation`.  Durations,
    us: csw1 7, fill 3, cup_gf_sh 2, microphysics 5, fluxes 1,
    relaxation 4."""
    names = {
        "kernel.dsw_csw1": ("void dsw::csw1(Metrics)", 7.0),
        "kernel.fill_q2_zero": (
            "(anonymous namespace)::fill_q2_zero_columns(long long, int)",
            3.0),
        "kernel.cup_gf_sh": (
            "(anonymous namespace)::cup_gf_sh_points(long long, int)", 2.0),
        "kernel.gfdl_microphysics": (
            "(anonymous namespace)::gfdl_microphysics_columns(long long)",
            5.0),
        "surface_fluxes": ("void at::native::elementwise_kernel<add>()", 1.0),
        "relaxation": ("void at::native::elementwise_kernel<mul>()", 4.0),
    }
    events, calls = [], []
    for s in sorted(rec.spans, key=lambda s: s.start):
        if s.name in names:
            name, dur = names[s.name]
            ts = 0.5 * (s.start + s.end)
            calls.append(spans.RuntimeCall(ts, "cudaLaunchKernel",
                                           (len(events),)))
            events.append(devtrace.Event(1e3 * len(events), dur, name,
                                         "kernel", "cudaLaunchKernel"))
    return dataclasses.replace(
        rec, events=events, runtime_calls=calls,
        peaks=counts.PEAKS["NVIDIA H100 80GB HBM3"])


def test_a_traced_cpu_run_is_correct_and_feeds_the_new_readers(
        monkeypatch):
    cell = small_cell(CELL)
    cell.traffic.update(warmup_steps=1, trace_steps=2)
    seen = []
    read_metrics = spec.read_metrics

    def spy(entries, kind, rec, root):
        seen.append(rec)
        return read_metrics(entries, kind, rec, root)

    monkeypatch.setattr(spec, "read_metrics", spy)
    out = load_run().run(cell, SEED, 0.05, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["checks"]["start_max_abs"] == [0.0, 0.0]
    assert not set(NEW) & set(out["metrics"])   # no device event on the CPU
    (rec,) = seen
    steps = rec.steps
    names = [s.name for s in rec.spans]
    for n in ("physics", "surface_fluxes", "relaxation",
              "kernel.fill_q2_zero", "kernel.cup_gf_sh",
              "kernel.gfdl_microphysics"):
        assert names.count(n) == steps, n

    rec = _with_device_events(rec)
    read = lambda name: spec.reader("metrics", name).read(rec)
    assert spans.analyse(rec)["span_launch_match"] == 1.0
    # fill 3 + cup 2 + microphysics 5 + fluxes 1 + relaxation 4 us a step
    assert read("physics_device_ms") == pytest.approx(0.015)
    assert read("moist_columns_device_ms") == pytest.approx(0.010)
    # the three counted calls at c12-L8: each input read and each output
    # written once, bytes over 3.35 TB/s (they bound every call here)
    c, cols = 6 * 12 * 12 * 8, 6 * 12 * 12
    nbytes = 4 * ((3 * c + c + 3 * c) + (4 * c + 2 * c)
                  + (7 * c + 5 * c + cols))
    assert sum(k.bytes for k in rec.calls[-3:]) == nbytes
    assert [k.wrapper for k in rec.calls[-3:]] == [
        "fill_q2_zero", "cup_gf_sh", "gfdl_microphysics"]
    assert read("moist_columns_roofline") == pytest.approx(
        100 * nbytes / 3.35e12 / 10e-6)
    # a shifted clock: the span reader reads nothing, the others still do
    off = dataclasses.replace(rec, runtime_calls=[
        c._replace(ts=c.ts + 1e9) for c in rec.runtime_calls])
    assert spec.reader("metrics", "physics_device_ms").read(off) is None
    assert spec.reader("metrics", "moist_columns_device_ms").read(off) \
        == pytest.approx(0.010)

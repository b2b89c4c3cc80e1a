"""The tool scripts of the port (geosongpu_tpu_torch/scripts/) on the CPU
at c8, and the console scripts of pyproject.toml.

bench_ladder reports a finite rung, and an error entry without a speed
for a state that goes non-finite; phase_profile's phases are the leaves
of benchmark/phases.measure_phases; the roofline's trace reader sums a
synthetic trace per `__global__` name and per wrapper, and its recorder
counts a step's bytes as chip_smoke.py's bound counts them on the
kernels' inputs; climatology recovers a zonal u = f(lat) bin by bin."""
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import tomllib
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu_torch.cli import PRESETS, build_model_for  # noqa: E402
from geosongpu_tpu_torch.scripts import (bench_ladder,  # noqa: E402
                                         device_of, hs_climatology,
                                         hs_presets, phase_profile,
                                         roofline)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
FUSED = "held_suarez_c48_l72_fused"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (several test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(preset=FUSED, npx=8, npz=8):
    cfg = dataclasses.replace(PRESETS[preset], npx=npx, npz=npz)
    return build_model_for(preset)(cfg, CPU)


def test_bench_ladder_finite_and_non_finite_rungs(tmp_path, capsys):
    out = tmp_path / "ladder.json"
    assert bench_ladder.main(["--rungs", "8", "--npz", "6", "--steps", "1",
                              "--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    (e,) = art["entries"]
    assert e["finite"] and e["config"] == "c8-L6" and e["card"] == "cpu"
    assert e["preset"] == FUSED and e["ms_per_step"] > 0.0
    assert e["gridpoints_per_s"] == pytest.approx(
        6 * 8 * 8 * 6 / e["ms_per_step"] * 1e3)
    assert json.loads(capsys.readouterr().out) == art
    start = _model(npz=6).init(perturb=1e-3)
    start.pt[0, 3, 4, 2] = float("nan")
    bad = bench_ladder.run_rung(8, 6, 1, CPU, start=start)
    assert not bad["finite"] and "pt" in bad["error"]
    assert "ms_per_step" not in bad and "gridpoints_per_s" not in bad
    assert bench_ladder.preset_for(192) == "held_suarez_c192_l72_fused"
    assert PRESETS[bench_ladder.preset_for(192)].n_split == 8


@pytest.mark.parametrize("preset", [FUSED, "held_suarez_c48_l72"])
def test_phase_profile_keys_are_the_phase_leaves(preset):
    from geosongpu_tpu_torch.benchmark.phases import measure_phases

    got = phase_profile.profile(preset, 8, 6, "cpu", inner=1)
    model = _model(preset, npz=6)
    tree = measure_phases(model, model.init(perturb=1e-3), inner=1)
    assert {k for k in got if not k.startswith("_")} == \
        {"full_step"} | set(tree.phases)
    assert got["_config"].startswith(f"{preset} c8-L6")
    assert got["_device"] == "cpu" and got["full_step"] > 0.0
    assert preset in hs_presets()


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


def test_roofline_reads_a_synthetic_trace(tmp_path):
    ns = "void (anonymous namespace)::"
    events = [
        _kernel(f"{ns}csw1(Metrics, float const*)", 10, 5.0),
        _kernel("at::native::vectorized_elementwise_kernel<4>", 16, 2.0),
        _kernel(f"{ns}hydro_columns(Metrics, int)", 20, 3.0),
        _kernel(f"{ns}csw2_winds(Metrics)", 24, 4.0),
        _kernel(f"{ns}fvtp2d_tile<2>(Metrics)", 30, 6.0),
        _kernel(f"{ns}transport_update(Metrics)", 37, 1.5),
        _kernel(f"{ns}hydro_columns(Metrics, int)", 40, 3.0),
        _kernel(f"{ns}wind_update<3, false>(Metrics)", 44, 7.0),
        _kernel(f"{ns}remap_banded_kernel<4>(float const*)", 60, 2.5),
        _kernel(f"{ns}csw1(Metrics, float const*)", 70, 5.5),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 9, "dur": 100.0, "pid": 0, "tid": 1},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80,
         "dur": 1.0, "pid": 0, "tid": 7},
    ]
    (tmp_path / "t.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    per_name = roofline.device_op_times(str(tmp_path))
    assert per_name[f"{ns}csw1(Metrics, float const*)"] == 10.5
    assert per_name[f"{ns}hydro_columns(Metrics, int)"] == 6.0
    assert per_name["at::native::vectorized_elementwise_kernel<4>"] == 2.0
    assert "cudaLaunchKernel" not in per_name and len(per_name) == 8
    assert sum(per_name.values()) == 39.5
    evs = roofline.kernel_events(str(tmp_path))
    assert [e[0] for e in evs] == sorted(e[0] for e in evs) and len(evs) == 10
    assert roofline.wrapper_times(evs) == {
        "dsw_csw1": 10.5, "dsw_csw2": 7.0, "dsw_transport": 7.5,
        "dsw_wind": 10.0, "remap_banded": 2.5}
    with pytest.raises(ValueError):
        roofline.wrapper_times(evs[:5])
    assert roofline.stage_of("at::native::reduce_kernel<512, 1>") is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_roofline_recorder_counts_the_bound_bytes():
    """The recorder's bytes of one fused step, per kernel, equal what
    chip_smoke.py's phase 15 reckons from kernel_inputs and the remap's
    three calls (the bytes of phase 3/4's bound), and the launch counts
    survive the recording."""
    from geosongpu_tpu_torch.ops.kernels import dsw

    model = _model()
    state = model.init(perturb=1e-3)
    before = dsw.dsw_csw1.launches
    calls = []
    with roofline.recording(calls):
        model.step(state)
    assert dsw.dsw_csw1.launches == before   # plain versions on the CPU
    assert dsw.dsw_csw1 in dsw.KERNELS
    got, n = defaultdict(float), defaultdict(int)
    for name, form, nbytes, points in calls:
        assert form == name and points > 0
        got[name] += nbytes
        n[name] += 1
    smoke = _chip_smoke()
    assert dict(n) == smoke.PATHS[FUSED][2]
    want = smoke.step_bytes(torch, np, model, CPU)
    assert set(want) == set(got)
    for k in want:
        assert got[k] == want[k], k


def test_roofline_form_of_each_call():
    assert roofline.form_of("dsw_transport", (None,) * 9) == "dsw_transport"
    assert roofline.form_of("dsw_transport", (None,) * 9 + ((1,),)) == \
        "dsw_transport nh"
    wind = [None] * 15
    assert roofline.form_of("dsw_wind", wind) == "dsw_wind blend"
    wind[7] = "div"
    assert roofline.form_of("dsw_wind", wind) == "dsw_wind"
    wind[14] = "delz"
    assert roofline.form_of("dsw_wind", wind) == "dsw_wind nh"


def test_roofline_needs_the_card():
    model = _model()
    with pytest.raises(RuntimeError, match="card"):
        roofline.roofline(model, model.init(perturb=1e-3), 1)


class _ZonalModel:
    """A model whose state is a zonal u = f(lat) and a uniform column."""

    def __init__(self, npz=4):
        self.config = dataclasses.replace(PRESETS["held_suarez_c48_l72"],
                                          npx=8, npz=npz, dt=900.0)
        n = self.config.npx
        rng = np.random.default_rng(2)
        self.lat = rng.uniform(-np.pi / 2, np.pi / 2, (6, n, n))
        self.lats = type("L", (), {"lat_c": torch.as_tensor(self.lat)})
        self.device = CPU
        u = np.repeat((20.0 * np.sin(2 * self.lat))[..., None], npz, -1)
        self.state = type("S", (), dict(
            ua=torch.as_tensor(u),
            pt=torch.full((6, n, n, npz), 300.0, dtype=torch.float32),
            delp=torch.full((6, n, n, npz), 1000.0, dtype=torch.float32)))
        self.steps = 0

    def run(self, state, steps):
        self.steps += steps
        return self.state


def test_climatology_recovers_a_zonal_wind():
    m = _ZonalModel()
    ubar, tbar, edges, nsamp = hs_climatology.climatology(m, m.state,
                                                          days=3.0,
                                                          spinup=1.0)
    assert nsamp == 8 and m.steps == 3 * 96
    assert ubar.shape == tbar.shape == (hs_climatology.NBINS, 4)
    assert edges[0] == -np.pi / 2 and edges[-1] == np.pi / 2
    b = np.clip(np.digitize(m.lat.ravel(), edges) - 1, 0, 31)
    f = 20.0 * np.sin(2 * m.lat.ravel())
    for k in range(hs_climatology.NBINS):
        if (b == k).any():
            np.testing.assert_allclose(ubar[k], f[b == k].mean(), rtol=1e-6)
        else:
            assert (ubar[k] == 0.0).all()
    # a uniform column: each level's T equal in every bin
    assert np.ptp(tbar[b.min():b.max() + 1], axis=0).max() < 1e-3
    jet, trop = hs_climatology.jet_and_tropics(ubar, edges)
    assert 15.0 < jet <= 20.0 and abs(trop) < 10.0


def test_hs_climatology_main_on_the_cpu(tmp_path, capsys):
    npz_out = tmp_path / "clim.npz"
    assert hs_climatology.main([
        "--npx", "8", "--npz", "6", "--days", "0.5", "--spinup", "0.25",
        "--dt", "3600", "--device", "cpu", "--out", str(tmp_path / "clim.png"),
        "--npz_out", str(npz_out)]) == 0
    d = np.load(npz_out)
    assert d["ubar"].shape == (32, 6) and np.isfinite(d["ubar"]).all()
    assert int(d["nsamp"]) == 1 and (tmp_path / "clim.png").exists()
    assert "jet max" in capsys.readouterr().out


def test_twins_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="--device cpu"):
        device_of("cuda")
    for main in (bench_ladder.main, phase_profile.main, hs_climatology.main,
                 roofline.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])


def test_console_scripts_resolve_to_the_port():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    port = {k: v for k, v in scripts.items()
            if k.startswith("geosongpu-tpu-torch")}
    assert set(port) == {"geosongpu-tpu-torch", "geosongpu-tpu-torch-hws",
                         "geosongpu-tpu-torch-validation",
                         "geosongpu-tpu-torch-plots",
                         "geosongpu-tpu-torch-interop"}
    for name, target in port.items():
        module, attr = target.split(":")
        assert module.startswith("geosongpu_tpu_torch.")
        fn = getattr(importlib.import_module(module), attr)
        assert callable(fn), name
        with pytest.raises(SystemExit) as e:
            fn(["--help"])
        assert e.value.code == 0

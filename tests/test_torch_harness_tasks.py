"""The port's CI tasks (HeldSuarez, Aquaplanet, the seven physics
standalones, HSClimatology) and the benchmark modules they import
(benchmark/timing.py, benchmark/phases.py) against the JAX package's, on
the CPU at the smoke entries' sizes.

- timing: the same record through both packages gives the same to_dict,
  compare and report text, and each package loads the other's file;
- phases: PhaseTree.to_dict and render agree; the port's Benchmark trees
  of held_suarez_bench_smoke (c8-L6, eager and fused) carry exactly the
  reference's leaf names for that configuration, every value finite and
  >= 0;
- the new experiment entries equal the reference's yaml entries, and each
  names tasks the port registers;
- Validation of both smoke entries through both packages' dispatch: both
  checks pass, the npz files have the same keys, and from the reference's
  own start state the final states agree within 1e-4 of max|reference|
  (u and v: or 2e-3 m/s; ql and qr: 1e-4 of max|qv|);
- the port's Benchmark action on both smoke entries;
- the checks of HeldSuarez, HSClimatology and the standalone tasks on
  synthetic inputs: the same outcome and message through both packages;
- HARDWARE_SAMPLING on the CPU through both packages: the port's record
  carries the host's energy and no card's, and its dump reads in the
  reference's analysis;
- a declared mesh larger than the host gives the reference's single-device
  description.

The port runs with one torch thread: the suite runs several workers on
the same cores.
"""
import dataclasses
import json
import math
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from geosongpu_tpu.benchmark import phases as j_phases  # noqa: E402
from geosongpu_tpu.benchmark import timing as j_timing  # noqa: E402
from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.core.config import MeshConfig as JaxMesh  # noqa: E402
from geosongpu_tpu.core.state import DycoreState as JaxState  # noqa: E402
from geosongpu_tpu.dycore import sw as j_sw  # noqa: E402
from geosongpu_tpu.harness import environment as j_env  # noqa: E402
from geosongpu_tpu.hws import analysis as j_hws_an  # noqa: E402
from geosongpu_tpu.hws import server as j_hws_server  # noqa: E402
from geosongpu_tpu.harness import task as j_task  # noqa: E402
from geosongpu_tpu.harness.tasks import climatology as j_clim  # noqa: E402
from geosongpu_tpu.harness.tasks import held_suarez as j_hs  # noqa: E402
from geosongpu_tpu.harness.tasks import \
    physics_standalone as j_phys  # noqa: E402
from geosongpu_tpu.models import aquaplanet as j_aq_model  # noqa: E402
from geosongpu_tpu.models import held_suarez as j_hs_model  # noqa: E402
from geosongpu_tpu.parallel import subtile as j_subtile  # noqa: E402
from geosongpu_tpu_torch.benchmark import phases as t_phases  # noqa: E402
from geosongpu_tpu_torch.benchmark import timing as t_timing  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.config import MeshConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.harness import environment as t_env  # noqa: E402
from geosongpu_tpu_torch.harness import task as t_task  # noqa: E402
from geosongpu_tpu_torch.harness.registry import Registry  # noqa: E402
from geosongpu_tpu_torch.harness.tasks import \
    aquaplanet  # noqa: E402,F401 - registers the Aquaplanet task
from geosongpu_tpu_torch.harness.tasks import \
    climatology as t_clim  # noqa: E402
from geosongpu_tpu_torch.harness.tasks import \
    held_suarez as t_hs  # noqa: E402
from geosongpu_tpu_torch.harness.tasks import \
    physics_standalone as t_phys  # noqa: E402
from geosongpu_tpu_torch.models import aquaplanet as t_aq_model  # noqa: E402
from geosongpu_tpu_torch.models import held_suarez as t_hs_model  # noqa: E402
from geosongpu_tpu_torch.parallel import subtile as t_subtile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GATE = 1e-4
WIND_ATOL = 2e-3
SMOKES = ("held_suarez_bench_smoke", "aquaplanet_bench_smoke")
# the reference's experiment entries the new tasks serve
PORTED = (
    "held_suarez_c12", "held_suarez_c24", "held_suarez_c48",
    "held_suarez_c192", "held_suarez_c16_sharded", "aquaplanet_c24",
    "aquaplanet_c48", "hs_climatology", "hs_climatology_smoke",
    "hs_climatology_full", "physics_standalone_fillq2zero",
    "physics_standalone_buoyancy", "physics_standalone_evap_subl_pdf",
    "physics_standalone_aer_activation",
    "physics_standalone_gfdl_microphysics",
    "physics_standalone_moist_rad_coup", "physics_standalone_cup_gf_sh",
    "physics_standalone_all") + SMOKES
TIMING = {"jax": j_timing, "torch": t_timing}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's models: the suite runs several
    workers on the same cores, and these small eager ops slow down by an
    order of magnitude when every worker starts a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn):
    """("ok", value) or (exception class name, message)."""
    try:
        return "ok", fn()
    except Exception as e:      # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)


def _reference_table():
    return yaml.safe_load(
        (ROOT / "geosongpu_tpu/harness/data/experiments.yaml").read_text())


# ---- benchmark/timing.py --------------------------------------------------

TREE = {"full_step_ms": 80.0,
        "phases_ms": {"halo_fill (xN)": 10.0, "vertical remap": 30.0},
        "phases_pct": {"halo_fill (xN)": 12.5, "vertical remap": 37.5},
        "unaccounted_ms": 40.0}


def _records(pkg):
    """Two records built from the same numbers in package pkg."""
    R = TIMING[pkg].BenchmarkRecord
    a = R(experiment="held_suarez_c48", backend="cuda:eager",
          grid={"npx": 48, "npz": 32}, setup_time_s=1.5, compile_time_s=3.25,
          step_time_s=[0.125, 0.1, 0.11], extra={"mesh": "single-device"},
          phase_tree=TREE)
    b = R(experiment="held_suarez_c48", backend="cuda:fused",
          grid={"npx": 48, "npz": 32}, step_time_s=[0.05, 0.04, 0.045, 0.06],
          energy={"cpu_kwh": 0.001, "tpu_kwh": 0.002, "total_kwh": 0.003})
    a.energy = {"cpu_kwh": 0.002, "tpu_kwh": 0.004, "total_kwh": 0.006}
    return a, b


def test_timing_record_compare_and_report_match_reference():
    (ja, jb), (ta, tb) = _records("jax"), _records("torch")
    assert ta.to_dict() == ja.to_dict() and tb.to_dict() == jb.to_dict()
    assert t_timing.compare(ta, tb) == j_timing.compare(ja, jb)
    assert "energy_ratio" in t_timing.compare(ta, tb)
    assert t_timing.report([ta, tb]) == j_timing.report([ja, jb])
    assert t_timing.report([]) == j_timing.report([])
    mixed = dataclasses.replace(tb, grid={"npx": 24, "npz": 32})
    jmixed = dataclasses.replace(jb, grid={"npx": 24, "npz": 32})
    assert t_timing.report([ta, mixed]) == j_timing.report([ja, jmixed])
    assert t_timing.report([ta, mixed]).startswith("WARNING: mixed grids")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_loads_the_others_record(writer, tmp_path):
    reader = "torch" if writer == "jax" else "jax"
    for rec in _records(writer):
        path = tmp_path / f"{rec.backend.replace(':', '_')}.json"
        rec.save(str(path))
        got = TIMING[reader].BenchmarkRecord.load(str(path))
        assert got.to_dict() == rec.to_dict()
        assert got.to_dict() == json.loads(path.read_text())


def test_step_timer_records_each_step():
    timer = t_timing.StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop()
    assert len(timer.times) == 3 and min(timer.times) >= 0.0


HS_DYC = dict(npx=8, npz=6, dt=1200.0, n_split=2)


@pytest.fixture(scope="module")
def hs_models():
    """Both packages' Held-Suarez models of c8-L6 and the port's rest
    state as numpy."""
    jm = j_hs_model.build_model(JaxConfig(**HS_DYC))
    tm = t_hs_model.build_model(DycoreConfig(**HS_DYC), CPU)
    return jm, tm, state_to_numpy(tm.init(perturb=0.0))


# ---- benchmark/phases.py --------------------------------------------------

PHASES = {"halo_fill (xN)": 0.004, "substep-minus-fill (xN)": 0.03,
          "vertical remap": 0.012, "forcing/physics": 0.001,
          "substep: c_sw (xN)": 0.01, "nh vertical solve (xN)": 0.002,
          "tracer transport": 0.009}


@pytest.mark.parametrize("full", [0.08, 0.05, 0.0])
def test_phase_tree_dict_and_render_match_reference(full):
    ref = j_phases.PhaseTree(full_step_s=full, phases=dict(PHASES))
    got = t_phases.PhaseTree(full_step_s=full, phases=dict(PHASES))
    assert got.accounted_s == ref.accounted_s
    assert got.to_dict() == ref.to_dict()
    assert got.render() == ref.render()


def _reference_leaf_names(jm, state, fused: bool, monkeypatch):
    """The reference's measure_phases leaves for its model jm with
    pallas_dycore=fused: its timing loop replaced by a constant, and its
    halo fill and each jitted stage by functions returning zeros (the
    names depend on the configuration, not on the times or values)."""
    model = SimpleNamespace(
        config=dataclasses.replace(jm.config, pallas_dycore=fused),
        ctx=jm.ctx, lats=jm.lats, step_fn=jm.step_fn)
    monkeypatch.setattr(j_phases, "_chain_time", lambda *a, **k: 0.0)
    monkeypatch.setattr(j_phases, "jax", SimpleNamespace(
        jit=lambda f: (lambda *a: (0.0, 0.0))))
    monkeypatch.setattr(j_sw, "fill_substep", lambda *a, **k: SimpleNamespace(
        pu=0.0, pv=0.0, pd_x=0.0, pd_y=0.0))
    return sorted(j_phases.measure_phases(model, state, inner=1).phases)


@pytest.fixture(scope="module")
def benchmarks(tmp_path_factory):
    """The port's Benchmark action on both smoke entries, on the CPU:
    {experiment: (env, artifact dir, workspace)}."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for exp in SMOKES:
            d = tmp_path_factory.mktemp(exp)
            env = t_task.dispatch(exp, "Benchmark",
                                  artifact_directory=str(d / "art"),
                                  workspace=str(d / "ws"), device="cpu")
            out[exp] = (env, d / "art", d / "ws")
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("member", ["eager", "fused"])
def test_measure_phases_leaves_match_reference(benchmarks, hs_models,
                                              member, monkeypatch):
    env = benchmarks["held_suarez_bench_smoke"][0]
    rec = {r.backend: r for r in env.get("hs.records")}[f"cpu:{member}"]
    tree = rec.phase_tree
    jm, _, arrays = hs_models
    state = JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    assert sorted(tree["phases_ms"]) == _reference_leaf_names(
        jm, state, member == "fused", monkeypatch)
    values = list(tree["phases_ms"].values()) + [tree["full_step_ms"],
                                                 tree["unaccounted_ms"]]
    assert all(math.isfinite(v) and v >= 0.0 for v in values)
    assert tree["full_step_ms"] > 0.0


@pytest.mark.parametrize("exp", SMOKES)
def test_benchmark_action_on_the_port(benchmarks, exp):
    env, art, ws = benchmarks[exp]
    key = "hs" if exp.startswith("held") else "aq"
    records = env.get(f"{key}.records")
    assert [r.backend for r in records] == ["cpu:eager", "cpu:fused"]
    assert env.get(f"{key}.record") is records[-1]
    eager, fused = (r.phase_tree for r in records)
    for tree in (eager, fused):
        assert tree["full_step_ms"] > 0.0
        assert "forcing/physics" in tree["phases_ms"]
        assert "tracer transport" in tree["phases_ms"]
    assert any(k.startswith("substep:") for k in eager["phases_ms"])
    assert not any(k.startswith("substep:") for k in fused["phases_ms"])
    for r in records:
        assert r.extra["mesh"] == "single-device"
        assert r.extra["launches"] == {}      # the CPU runs the plain forms
        assert r.extra["remap_leaf"].startswith(
            "the step's remap block: remap_banded (band 6)")
        assert len(r.step_time_s) == 2 and r.median_step_s > 0.0
    rep = (art / "report_benchmark.out").read_text()
    assert f"{exp} [cpu:eager] c8-L6" in rep
    assert f"{exp}[cpu:fused] vs {exp}[cpu:eager]" in rep
    for name in ("eager", "fused"):
        assert (ws / f"benchmark_{exp}_{name}.json").exists()
        assert (art / f"benchmark_{exp}_cpu:{name}.json").exists()
    fields = {"u", "v", "delp", "pt", "ps"} | ({"q"} if key == "aq" else set())
    assert set(np.load(ws / f"state_{exp}.npz")) == fields


def test_aquaplanet_trees_have_the_held_suarez_leaves(benchmarks):
    for member in range(2):
        hs, aq = (benchmarks[exp][0].get(f"{k}.records")[member].phase_tree
                  for exp, k in zip(SMOKES, ("hs", "aq")))
        assert sorted(aq["phases_ms"]) == sorted(hs["phases_ms"])


# ---- the experiment table -------------------------------------------------

@pytest.mark.parametrize("name", PORTED)
def test_table_entry_equals_reference_and_names_port_tasks(name):
    assert t_task.get_config(name) == _reference_table()[name]
    for task_name in t_task.get_config(name)["tasks"]:
        Registry.get(task_name)


# ---- Validation through both packages' dispatch ---------------------------

def _reference_start(exp):
    """The reference model's start state of the experiment (the task's
    init(perturb=1e-3)), as numpy."""
    raw = _reference_table()[exp]["experiment"]
    build = (j_aq_model if raw["model"] == "aquaplanet"
             else j_hs_model).build_model
    s = build(JaxConfig(**raw["dycore"])).init(perturb=1e-3)
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


@pytest.mark.parametrize("exp", SMOKES)
def test_smoke_validation_matches_reference(exp, tmp_path, monkeypatch):
    ref_env = j_task.dispatch(exp, "Validation",
                              artifact_directory=str(tmp_path / "jax_art"),
                              workspace=str(tmp_path / "jax_ws"))
    start = _reference_start(exp)
    cls = (t_aq_model.AquaplanetModel if exp.startswith("aqua")
           else t_hs_model.HeldSuarezModel)
    monkeypatch.setattr(cls, "init", lambda self, perturb=1e-3, seed=0:
                        state_from_numpy(start, self.device))
    env = t_task.dispatch(exp, "Validation",
                          artifact_directory=str(tmp_path / "art"),
                          workspace=str(tmp_path / "ws"), device="cpu")
    key = "aq" if exp.startswith("aqua") else "hs"
    (rec,) = env.get(f"{key}.records")
    assert rec.backend == "cpu" and rec.phase_tree is None
    assert (tmp_path / "art" / "report_benchmark.out").exists()
    npz = f"state_{exp}.npz"
    assert set(np.load(tmp_path / "ws" / npz)) == set(
        np.load(tmp_path / "jax_ws" / npz))

    ref_state = ref_env.get(f"{key}.final_state")
    ref = {f.name: np.asarray(getattr(ref_state, f.name))
           for f in dataclasses.fields(ref_state)}
    got = state_to_numpy(env.get(f"{key}.final_state"))
    for f in ("u", "v", "delp", "pt", "ps"):
        scale = float(np.abs(ref[f]).max())
        d = float(np.abs(ref[f] - got[f]).max())
        assert d <= max(GATE * scale, WIND_ATOL if f in ("u", "v") else 0.0), \
            (f, d, scale)
    assert np.abs(got["u"]).max() > 1e-3    # the run moved the air
    if key == "aq":
        qv_max = float(np.abs(ref["q"][..., 0]).max())
        for n in range(3):
            d = float(np.abs(ref["q"][..., n] - got["q"][..., n]).max())
            assert d <= GATE * qv_max, (n, d, qv_max)


# ---- the checks on synthetic inputs ---------------------------------------

def _hs_case(arrays, case):
    a = {k: v.copy() for k, v in arrays.items()}
    if case == "non-finite":
        a["pt"][2, 3, 4, 1] = np.nan
    elif case == "ps out of range":
        a["ps"][1, 2, 2] = 4.0e4
    elif case == "mass drift":
        a["delp"] *= np.float32(1.01)
    elif case == "deformation":
        a["omga"][0, 1, 1, 2] = 300.0
    elif case == "passes":
        a["omga"][:] = 0.05
    return a


HS_CASES = ("passes", "non-finite", "ps out of range", "mass drift",
            "deformation", "no results")


@pytest.mark.parametrize("case", HS_CASES)
def test_held_suarez_check_matches_reference(hs_models, case, tmp_path):
    jm, tm, arrays = hs_models
    a = _hs_case(arrays, case)
    got = {}
    for pkg, model, env_mod, task in (
            ("jax", jm, j_env, j_hs.HeldSuarez),
            ("torch", tm, t_env, t_hs.HeldSuarez)):
        env = env_mod.Environment("held_suarez_bench_smoke", "Validation",
                                  str(tmp_path / pkg))
        env.set("CI_WORKSPACE", str(tmp_path / pkg))
        if case != "no results":
            state = (JaxState(**{k: jnp.asarray(v) for k, v in a.items()})
                     if pkg == "jax" else state_from_numpy(a, CPU))
            rec = TIMING[pkg].BenchmarkRecord(
                "held_suarez_bench_smoke", "cpu", {"npx": 8, "npz": 6},
                step_time_s=[0.1])
            env.set("hs.final_state", state)
            env.set("hs.records", [rec])
            env.set("hs.model", model)
        got[pkg] = _outcome(lambda: task().check({}, env))
    assert got["torch"] == got["jax"]
    want = {"passes": ("ok", True), "no results": ("ok", False)}.get(case)
    assert got["jax"] == want if want else got["jax"][0] == "CICheckException"


def _climatologies():
    """The synthetic climatologies of tests/test_climatology_gate.py: an
    HS94-like structure, and the same with no eddies, an isothermal
    midtroposphere and an equatorial jet."""
    nbins, npz = 24, 16
    edges = np.linspace(-np.pi / 2, np.pi / 2, nbins + 1)
    latc = np.degrees(0.5 * (edges[:-1] + edges[1:]))
    sig = (np.arange(npz) + 0.5) / npz
    ubar = (28.0 * np.exp(-((np.abs(latc)[:, None] - 45) / 12) ** 2)
            * np.exp(-((sig[None, :] - 0.25) / 0.25) ** 2))
    ubar[np.abs(latc) < 15, -2:] = -3.0
    tbar = (315 - 60 * np.sin(np.radians(latc))[:, None] ** 2
            ) * sig[None, :] ** 0.28
    uv = (60.0 * np.sign(latc)[:, None]
          * np.exp(-((np.abs(latc)[:, None] - 35) / 10) ** 2)
          * np.exp(-((sig[None, :] - 0.3) / 0.2) ** 2))
    bad_u = np.roll(ubar, -8, axis=0)
    bad_u[np.abs(latc) < 15, -2:] = -3.0
    return edges, {
        "passes": (ubar, tbar, uv),
        "no eddies": (ubar, tbar, np.zeros_like(uv)),
        "isothermal": (ubar, np.full_like(tbar, 150.0), uv),
        "equatorial jet": (bad_u, tbar, uv),
        "no results": None,
    }


@pytest.mark.parametrize("case", list(_climatologies()[1]))
def test_climatology_check_matches_reference(case, tmp_path):
    edges, cases = _climatologies()
    got = {}
    for pkg, env_mod, task in (("jax", j_env, j_clim.HSClimatology),
                               ("torch", t_env, t_clim.HSClimatology)):
        env = env_mod.Environment("x", "Validation", str(tmp_path / pkg))
        env.set("CI_WORKSPACE", str(tmp_path))
        if cases[case] is not None:
            for key, value in zip(("clim.ubar", "clim.tbar", "clim.uv_eddy"),
                                  cases[case]):
                env.set(key, value)
            env.set("clim.edges", edges)
        got[pkg] = _outcome(lambda: task().check({"jet_floor_ms": 10.0}, env))
    assert got["torch"] == got["jax"]
    want = {"passes": ("ok", True), "no results": ("ok", False)}.get(case)
    assert got["jax"] == want if want else got["jax"][0] == "CICheckException"


def _climatology_sample(n, delp0):
    """The state fields a stubbed model.run returns after n steps in all:
    seeded by n, with u'v' correlated so the eddy flux is not zero."""
    rng = np.random.default_rng(n)
    shape = delp0.shape
    ua = rng.normal(0.0, 10.0, shape)
    return {"ua": ua.astype(np.float32),
            "va": (0.3 * ua + rng.normal(0.0, 5.0, shape)).astype(np.float32),
            "pt": (300.0 + rng.normal(0.0, 5.0, shape)).astype(np.float32),
            "delp": (delp0 * (1.0 + 1e-3 * rng.standard_normal(shape))
                     ).astype(np.float32)}


def test_climatology_run_action_matches_reference(tmp_path, monkeypatch):
    """HSClimatology.run_action of hs_climatology_smoke through both
    packages on the CPU, each model's run stubbed to return the same
    seeded states after the same number of steps: the start state each
    run receives is the committed spun-up fixture, and the zonal means
    (ubar, vbar, tbar), the eddy flux uv_eddy, the bin edges, the env keys
    and the npz agree to 1e-6 relative (tbar goes through each package's
    float32 Exner function; the rest is the same numpy arithmetic)."""
    exp = "hs_climatology_smoke"
    fixture = np.load(ROOT / "tests/data/hs_c12L16_spunup14d.npz")
    first, envs = {}, {}
    for pkg, hs_mod, task_mod, env_mod, clim in (
            ("jax", j_hs_model, j_task, j_env, j_clim),
            ("torch", t_hs_model, t_task, t_env, t_clim)):
        seen = {"steps": 0}

        def run(self, state, steps, pkg=pkg, seen=seen):
            if "u" not in seen:
                seen["u"] = (np.asarray(state.u) if pkg == "jax"
                             else state.u.cpu().numpy())
            seen["steps"] += steps
            new = _climatology_sample(seen["steps"], fixture["delp"])
            arr = (jnp.asarray if pkg == "jax" else torch.from_numpy)
            return dataclasses.replace(
                state, **{k: arr(v) for k, v in new.items()})

        monkeypatch.setattr(hs_mod.HeldSuarezModel, "run", run)
        raw = task_mod.get_config(exp)
        env = env_mod.Environment(
            exp, "Validation", str(tmp_path / pkg / "art"),
            config=task_mod.ExperimentConfig.from_dict(
                {"name": exp, **raw["experiment"]}))
        env.set("CI_WORKSPACE", str(tmp_path / pkg / "ws"))
        env.set("device", "cpu")
        clim.HSClimatology().run_action(raw, env)
        envs[pkg] = (env, _outcome(
            lambda: clim.HSClimatology().check(raw, env)))
        first[pkg] = seen
    assert first["torch"]["steps"] == first["jax"]["steps"] > 0
    for pkg in first:
        np.testing.assert_array_equal(first[pkg]["u"], fixture["u"])

    (ref_env, ref_out), (env, out) = envs["jax"], envs["torch"]
    assert out == ref_out
    assert env.get("clim.device") == "cpu"
    for key in ("clim.ubar", "clim.tbar", "clim.uv_eddy", "clim.edges"):
        np.testing.assert_allclose(env.get(key), ref_env.get(key), rtol=1e-6,
                                   atol=0.0, err_msg=key)
    assert np.abs(env.get("clim.uv_eddy")).max() > 1.0
    ref = np.load(tmp_path / "jax" / "ws" / "hs_climatology.npz")
    got = np.load(tmp_path / "torch" / "ws" / "hs_climatology.npz")
    assert set(got) == set(ref) | {"device"} and str(got["device"]) == "cpu"
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=0.0,
                                   err_msg=key)


def test_physics_standalone_all_matches_reference(tmp_path):
    """Both packages' seven tasks on the five datasets: both pass, the npz
    files have the same names and keys.  The port runs through its
    command line."""
    from geosongpu_tpu_torch.cli import main

    j_task.dispatch("physics_standalone_all", "All",
                    artifact_directory=str(tmp_path / "jax"),
                    workspace=str(tmp_path / "jax"))
    assert main(["ci", "physics_standalone_all", "--artifact",
                 str(tmp_path / "torch"), "--workspace",
                 str(tmp_path / "torch"), "--device", "cpu"]) == 0
    files = {pkg: sorted(p.name for p in (tmp_path / pkg).glob("*.npz"))
             for pkg in ("jax", "torch")}
    assert len(files["torch"]) == 7 * 5 and files["torch"] == files["jax"]
    for name in files["jax"]:
        assert set(np.load(tmp_path / "torch" / name)) == set(
            np.load(tmp_path / "jax" / name)), name


@pytest.mark.parametrize("kernel", list(t_phys.gate.KERNELS))
def test_standalone_check_message_matches_reference(kernel):
    """A result pair 2e-4 apart in its last variable of the second
    dataset fails both checks with the same message; the first dataset
    passes."""
    a = np.ones((4, 3), np.float32)
    b = (a * np.float32(1.0 + 2e-4)).astype(np.float32)
    good = ({"x": a, "y": a}, {"x": a, "y": a})
    bad = ({"x": a, "y": a}, {"x": a, "y": b})
    got = {}
    for pkg, mod in (("jax", j_phys), ("torch", t_phys)):
        env = (j_env if pkg == "jax" else t_env).Environment(
            "x", "All", ".")
        env.set(f"physics.{kernel}.results", [good, bad])
        got[pkg] = _outcome(lambda: getattr(mod, kernel)().check({}, env))
        env.set(f"physics.{kernel}.results", [good])
        assert getattr(mod, kernel)().check({}, env)
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == "CICheckException"
    assert got["jax"][1].startswith(f"{kernel} dataset 1 var y: rel RMS")


# ---- hardware sampling, what the port refuses, and the mesh entry ---------

def test_hardware_sampling_fills_the_record_on_the_cpu(tmp_path,
                                                      monkeypatch):
    """HARDWARE_SAMPLING=1, Validation of the smoke entry through both
    packages on the CPU: the port's record has the reference's energy keys
    with the host's model energy and no card's, and a dump of one sample a
    timed step with the reference's series plus their times, which the
    reference's analysis reads."""
    monkeypatch.setenv("HARDWARE_SAMPLING", "1")
    exp = "held_suarez_bench_smoke"
    ref_env = j_task.dispatch(exp, "Validation",
                              artifact_directory=str(tmp_path / "jax_art"),
                              workspace=str(tmp_path / "jax_ws"))
    env = t_task.dispatch(exp, "Validation",
                          artifact_directory=str(tmp_path / "art"),
                          workspace=str(tmp_path / "ws"), device="cpu")
    (ref,), (rec,) = ref_env.get("hs.records"), env.get("hs.records")
    steps = env.config.run.steps
    assert set(rec.energy) == set(ref.energy)
    assert rec.energy["cpu_kwh"] > 0 and rec.energy["tpu_kwh"] == 0
    assert rec.energy["total_kwh"] == rec.energy["cpu_kwh"]
    assert rec.extra["gpu_energy_j_counter"] == 0.0
    assert rec.extra["j_per_step"] == 0.0 and rec.extra["window_s"] > 0
    dump = rec.extra["hws_dump"]
    assert dump.startswith(str(tmp_path / "ws"))
    ref_keys = set(j_hws_an.load_data(ref.extra["hws_dump"]))
    data = j_hws_an.load_data(dump)
    assert set(data) == ref_keys | {"t_s", "device", "gpu_name", "gpu_uuid",
                                    "power_limit_w"}
    assert all(len(data[k]) == steps for k in j_hws_server.FIELDS + ("t_s",))
    assert str(data["device"]) == "cpu"
    assert j_hws_an.energy_envelope(data).cpu_kwh > 0
    # the record's host energy is the integral over the samples' times
    cpu_j = rec.energy["cpu_kwh"] * 3.6e6
    assert cpu_j == pytest.approx(
        np.trapezoid(data["cpu_psu"], x=data["t_s"]), rel=1e-12)
    # saved and reloaded through the report of the artifact directory
    got = t_timing.BenchmarkRecord.load(str(
        tmp_path / "art" / f"benchmark_{exp}_cpu.json"))
    assert got.energy == rec.energy


@pytest.mark.parametrize("layout", [dict(face=6), dict(face=1, x=4, y=2)])
def test_declared_mesh_gives_the_reference_description(layout, monkeypatch):
    """A layout larger than the host: the reference's string for a host of
    one device (its own branch, parallel/subtile.py:860-870)."""
    one = jax.devices()[:1]
    monkeypatch.setattr(j_subtile.jax, "devices", lambda *a: one)
    ref = j_subtile.build_mesh_stepper(SimpleNamespace(step_fn=None),
                                       JaxMesh(**layout), None)[3]
    model = SimpleNamespace(step=None, device=CPU)
    got = t_subtile.build_mesh_stepper(model, MeshConfig(**layout))[3]
    assert got == ref and got.startswith("single-device (mesh ")
    assert t_subtile.build_mesh_stepper(model, MeshConfig())[3] \
        == "single-device"


def test_mesh_the_host_could_hold_runs_sharded(tmp_path):
    """held_suarez_c16_sharded through dispatch on 8 stacked CPU ranks:
    the (2, 4) faces-local layout runs sharded, the record carries the
    reference's mesh string, and the task's gates run on the unplaced
    global state (tests/test_harness.py::test_sharded_experiment_dispatch)."""
    env = t_task.dispatch("held_suarez_c16_sharded", "Validation",
                          artifact_directory=str(tmp_path / "art"),
                          workspace=str(tmp_path / "ws"), device="cpu",
                          stacked_ranks=True)
    rec = env.get("hs.record")
    assert rec.extra["mesh"] == "subtile faces-local (2,4), 8 devices"
    state = env.get("hs.final_state")
    assert tuple(state.u.shape) == (6, 17, 16, 16)
    assert bool(torch.isfinite(state.u).all())


# ---- the climatology end to end -------------------------------------------

@pytest.mark.slow
def test_hs_climatology_smoke_through_dispatch(tmp_path):
    env = t_task.dispatch("hs_climatology_smoke", "Validation",
                          artifact_directory=str(tmp_path / "art"),
                          workspace=str(tmp_path / "ws"), device="cpu")
    assert env.get("clim.device") == "cpu"
    d = np.load(tmp_path / "art" / "hs_climatology.npz")
    assert d["ubar"].shape == (24, 16) and str(d["device"]) == "cpu"
    assert np.isfinite(d["ubar"]).all() and np.isfinite(d["tbar"]).all()

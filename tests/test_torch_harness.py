"""The port's harness (geosongpu_tpu_torch/harness) against the JAX
package's: the copied base (Registry, Environment, dispatch with its
ci_metadata), the experiment table, and the BaroclinicWave task's check on
synthetic results, each case run through both packages with the same
outcome and message.  Then what differs on purpose: the table and
ci_metadata are JSON (the port imports no yaml), and the task's check
does not copy its npz onto itself when the workspace is the artifact
directory.  Last, the JW06 task end to end on the CPU at c8, through both
packages' dispatch."""
import ast
import json
import os
import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from geosongpu_tpu.harness import environment as j_env  # noqa: E402
from geosongpu_tpu.harness import exceptions as j_exc  # noqa: E402
from geosongpu_tpu.harness import registry as j_reg  # noqa: E402
from geosongpu_tpu.harness import task as j_task  # noqa: E402
from geosongpu_tpu.harness.tasks import baroclinic as j_bw  # noqa: E402
from geosongpu_tpu_torch.harness import environment as t_env  # noqa: E402
from geosongpu_tpu_torch.harness import exceptions as t_exc  # noqa: E402
from geosongpu_tpu_torch.harness import registry as t_reg  # noqa: E402
from geosongpu_tpu_torch.harness import task as t_task  # noqa: E402
from geosongpu_tpu_torch.harness.tasks import baroclinic as t_bw  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "geosongpu_tpu_torch"
# package -> (registry, environment, exceptions, task, baroclinic task)
PACKAGES = {"jax": (j_reg, j_env, j_exc, j_task, j_bw),
            "torch": (t_reg, t_env, t_exc, t_task, t_bw)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's models: the suite runs several
    workers on the same cores, and these small eager ops slow down by an
    order of magnitude when every worker starts a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dummy_task(pkg: str):
    """A task registered in the package's Registry as "_DummyTask": it
    records that it ran, and its check returns the experiment's "ok"."""
    reg, _, _, task, _ = PACKAGES[pkg]

    class _DummyTask(task.TaskBase):
        def run_action(self, config, env):
            env.set("dummy.ran", True)

        def check(self, config, env):
            return bool(config["ok"])

    return reg.Registry.register(_DummyTask)


def _outcome(fn):
    """("ok", value) or (exception class name, message)."""
    try:
        return "ok", fn()
    except Exception as e:      # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_registry_register_and_get(pkg):
    reg = PACKAGES[pkg][0].Registry
    cls = _dummy_task(pkg)
    assert reg.get("_DummyTask") is cls
    with pytest.raises(KeyError, match="'definitely_not_registered' is not "
                                       "registered"):
        reg.get("definitely_not_registered")


def test_registry_unknown_name_message_matches():
    """The same error and message up to the list of known tasks, which
    differs: the port has one task so far."""
    for pkg in PACKAGES:
        _dummy_task(pkg)
    msgs = {pkg: _outcome(lambda: PACKAGES[pkg][0].Registry.get("nope"))
            for pkg in PACKAGES}
    for kind, msg in msgs.values():
        assert kind == "KeyError" and "'_DummyTask'" in msg
    assert msgs["jax"][1].split("; known")[0] \
        == msgs["torch"][1].split("; known")[0]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_environment_vault_and_workspace(pkg, monkeypatch):
    Env = PACKAGES[pkg][1].Environment
    monkeypatch.delenv("CI_WORKSPACE", raising=False)
    monkeypatch.setenv("GEOSONGPU_TEST_FALLBACK", "from-os")
    env = Env("exp", "All", "/nowhere")
    with pytest.raises(RuntimeError, match="CI_WORKSPACE is not set"):
        env.CI_WORKSPACE
    assert env.get("missing", 3) == 3 and not env.exists("missing")
    assert env.get("GEOSONGPU_TEST_FALLBACK") == "from-os"
    env.set("GEOSONGPU_TEST_FALLBACK", "from-vault")
    assert env.get("GEOSONGPU_TEST_FALLBACK") == "from-vault"
    monkeypatch.setenv("CI_WORKSPACE", "/from/os")
    assert env.CI_WORKSPACE == "/from/os"
    env.set("CI_WORKSPACE", "/from/vault")
    assert env.CI_WORKSPACE == "/from/vault" and env.exists("CI_WORKSPACE")


def _dispatch(pkg, tmp_path, monkeypatch, ok=True, setup_only=False):
    """The outcome of dispatch of an experiment whose one task is
    _DummyTask (("ok", env) or the error and its message), and the
    workspace."""
    task = PACKAGES[pkg][3]
    _dummy_task(pkg)
    table = {"dummy_exp": {"tasks": ["_DummyTask"], "ok": ok}}
    monkeypatch.setattr(task, "load_experiments", lambda: table)
    ws = tmp_path / pkg
    return _outcome(lambda: task.dispatch(
        "dummy_exp", "Validation", artifact_directory=str(ws),
        setup_only=setup_only, workspace=str(ws))), ws


def test_dispatch_runs_and_writes_metadata(tmp_path, monkeypatch):
    meta = {}
    for pkg in PACKAGES:
        (kind, env), ws = _dispatch(pkg, tmp_path, monkeypatch)
        assert kind == "ok" and env.get("dummy.ran") is True
        text = (ws / "ci_metadata").read_text()
        meta[pkg] = yaml.safe_load(text) if pkg == "jax" else json.loads(text)
    assert meta["torch"]["action"] == "Validation"
    for m in meta.values():
        m.pop("timestamp")
    assert meta["jax"] == meta["torch"]


def test_dispatch_raises_on_failed_check(tmp_path, monkeypatch):
    got = {pkg: _dispatch(pkg, tmp_path, monkeypatch, ok=False)[0]
           for pkg in PACKAGES}
    assert got["jax"][0] == "CICheckException"
    assert got["jax"] == got["torch"]


def test_dispatch_honours_setup_only(tmp_path, monkeypatch):
    for pkg in PACKAGES:
        (kind, env), ws = _dispatch(pkg, tmp_path, monkeypatch, ok=False,
                                    setup_only=True)
        assert kind == "ok" and env.get("dummy.ran") is None
        assert not (ws / "ci_metadata").exists()


def test_unknown_experiment_message_matches():
    got = {pkg: _outcome(lambda: PACKAGES[pkg][3].get_config("nope"))[0]
           for pkg in PACKAGES}
    assert got == {"jax": "KeyError", "torch": "KeyError"}


def test_jw_experiments_equal_the_reference_table():
    ref = yaml.safe_load(
        (ROOT / "geosongpu_tpu/harness/data/experiments.yaml").read_text())
    table = t_task.load_experiments()
    # the JW06 entries and those of the HeldSuarez, Aquaplanet,
    # HSClimatology and physics standalone tasks
    tasks = {"HeldSuarez", "Aquaplanet", "HSClimatology", "FillQ2Zero",
             "Buoyancy", "EvapSublPdfLoop", "AerActivation",
             "GFDLMicrophysics", "MoistRadCoup", "CupGfSh"}
    ported = sorted(name for name, raw in ref.items()
                    if set(raw.get("tasks", [])) & tasks)
    assert len(ported) == 20
    assert sorted(table) == sorted(["jw_baroclinic_c48",
                                    "jw_baroclinic_c48_fused",
                                    "jw_baroclinic_smoke"] + ported)
    for name in ["jw_baroclinic_c48", "jw_baroclinic_smoke"] + ported:
        assert table[name] == ref[name], name
    fused = json.loads(json.dumps(ref["jw_baroclinic_c48"]))
    fused["experiment"]["dycore"]["pallas_dycore"] = True
    assert table["jw_baroclinic_c48_fused"] == fused


# synthetic (steady dev, ps_min by day, low lat) of the c48 experiment:
# one case per gate, and one that passes
DAYS = [99990.0, 99950.0, 99850.0, 99700.0, 99500.0, 99300.0, 98800.0,
        97800.0, 96800.0, 94900.0]
CHECK_CASES = {
    "passes": (310.0, DAYS, 45.0),
    "steady state broke": (1600.0, DAYS, 45.0),
    "grew too fast": (310.0, DAYS[:3] + [98500.0] + DAYS[4:], 45.0),
    "failed to deepen": (310.0, DAYS[:8] + [99100.0] + DAYS[9:], 45.0),
    "over-deepened": (310.0, DAYS[:8] + [89000.0] + DAYS[9:], 45.0),
    "low out of band": (310.0, DAYS, 15.0),
    "no results": (None, None, None),
}


def _check(pkg, case, tmp_path):
    _, env_mod, _, _, bw = PACKAGES[pkg]
    dev, mins, lat = CHECK_CASES[case]
    env = env_mod.Environment("jw_baroclinic_c48", "Validation",
                              str(tmp_path / pkg / "artifact"))
    env.set("CI_WORKSPACE", str(tmp_path / pkg / "ws"))
    for key, value in (("jw.steady_ps_dev", dev), ("jw.ps_min_by_day", mins),
                       ("jw.low_lat", lat)):
        if value is not None:
            env.set(key, value)
    raw = t_task.get_config("jw_baroclinic_c48")
    return _outcome(lambda: bw.BaroclinicWave().check(raw, env))


@pytest.mark.parametrize("case", CHECK_CASES)
def test_baroclinic_check_matches_reference(case, tmp_path):
    ref, got = _check("jax", case, tmp_path), _check("torch", case, tmp_path)
    assert ref == got
    want = {"passes": ("ok", True), "no results": ("ok", False)}.get(case)
    assert ref == want if want else ref[0] == "CICheckException"


def test_check_keeps_npz_when_workspace_is_artifact_dir(tmp_path):
    """The reference copies the npz onto itself there (shutil's
    SameFileError); the port leaves it in place."""
    outcomes = {}
    for pkg in PACKAGES:
        _, env_mod, _, _, bw = PACKAGES[pkg]
        d = tmp_path / pkg
        d.mkdir()
        np.savez_compressed(d / "jw_baroclinic.npz", ps_min_by_day=DAYS)
        env = env_mod.Environment("jw_baroclinic_c48", "Validation", str(d))
        env.set("CI_WORKSPACE", str(d))
        env.set("jw.steady_ps_dev", 310.0)
        env.set("jw.ps_min_by_day", DAYS)
        env.set("jw.low_lat", 45.0)
        raw = t_task.get_config("jw_baroclinic_c48")
        outcomes[pkg] = _outcome(lambda: bw.BaroclinicWave().check(raw, env))
        assert np.load(d / "jw_baroclinic.npz")["ps_min_by_day"][-1] \
            == DAYS[-1]
    assert outcomes["jax"][0] == "SameFileError"
    assert outcomes["torch"] == ("ok", True)


def test_check_copies_npz_to_another_artifact_dir(tmp_path):
    env = t_env.Environment("jw_baroclinic_c48", "Validation",
                            str(tmp_path / "art"))
    env.set("CI_WORKSPACE", str(tmp_path / "ws"))
    os.makedirs(tmp_path / "ws")
    np.savez_compressed(tmp_path / "ws" / "jw_baroclinic.npz", a=[1.0])
    for key, value in zip(("jw.steady_ps_dev", "jw.ps_min_by_day",
                           "jw.low_lat"), CHECK_CASES["passes"]):
        env.set(key, value)
    assert t_bw.BaroclinicWave().check(
        t_task.get_config("jw_baroclinic_c48"), env)
    assert (tmp_path / "art" / "jw_baroclinic.npz").exists()


def test_no_module_of_the_port_imports_yaml():
    """The card's machine has no pyyaml: the port reads JSON."""
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] != "yaml", f"{path} imports yaml"


def test_cli_ci_setup_only_and_device(tmp_path, capsys):
    from geosongpu_tpu_torch.cli import main

    assert main(["ci", "jw_baroclinic_smoke", "Validation", "--setup_only",
                 "--artifact", str(tmp_path), "--workspace", str(tmp_path),
                 "--device", "cpu"]) == 0
    assert "[setup-only] skipping BaroclinicWave" in capsys.readouterr().out
    assert not (tmp_path / "ci_metadata").exists()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            main(["ci", "jw_baroclinic_smoke", "Validation", "--setup_only"])


# a JW06 experiment small enough for the CPU: c8-L10, 1 + 4 days of 12
# steps; the caps are opened, and at c8 the deepest low of day 4 lies
# outside the latitude band, so both checks raise there
TINY = {"experiment": {"model": "baroclinic_wave", "dycore": {
    "npx": 8, "npz": 10, "dt": 7200.0, "n_split": 8, "ntracers": 0}},
    "steady_days": 1, "wave_days": 4, "deep_day": 4, "deep_cap_pa": 1.0e6,
    "steady_ps_cap_pa": 1.0e6, "tasks": ["BaroclinicWave"]}


def test_baroclinic_task_end_to_end_matches_reference(tmp_path):
    """Both packages' task on the same small experiment, run (run_action
    and ci_metadata) and checked: the port's results (steady dev, ps_min by
    day, low lat, the npz) against the reference's, ps within 1e-4 of 1e5
    Pa, and the same outcome of the check."""
    got = {}
    for pkg in PACKAGES:
        _, env_mod, _, task, bw = PACKAGES[pkg]
        cfg_mod = task.ExperimentConfig
        env = env_mod.Environment(
            "jw_tiny", "Validation", str(tmp_path / pkg / "art"),
            config=cfg_mod.from_dict({"name": "jw_tiny",
                                      **TINY["experiment"]}))
        env.set("CI_WORKSPACE", str(tmp_path / pkg / "ws"))
        env.set("device", "cpu")
        t = bw.BaroclinicWave()
        t.run(TINY, env)
        outcome = _outcome(lambda: t.check(TINY, env))
        npz = np.load(tmp_path / pkg / "ws" / "jw_baroclinic.npz")
        assert (tmp_path / pkg / "ws" / "ci_metadata").exists()
        got[pkg] = (env.get("jw.steady_ps_dev"), env.get("jw.ps_min_by_day"),
                    env.get("jw.low_lat"), npz["ps_final"], outcome)
    (dev_r, mins_r, lat_r, ps_r, out_r), (dev_t, mins_t, lat_t, ps_t, out_t) \
        = got["jax"], got["torch"]
    assert len(mins_t) == 4 and all(np.isfinite(mins_t))
    assert abs(dev_t - dev_r) <= 10.0
    np.testing.assert_allclose(mins_t, mins_r, rtol=0, atol=10.0)
    np.testing.assert_allclose(ps_t, ps_r, rtol=0, atol=10.0)
    assert lat_t == lat_r
    assert out_t == out_r and out_r[0] == "CICheckException"

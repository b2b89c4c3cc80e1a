"""The port's job harness (geosongpu_tpu_torch/harness/{shell,jobqueue,
launcher,checkpoint}.py) and its Heartbeat, CIClean and CIInfo tasks
against the JAX package's.

The cases of tests/test_shell_launcher.py and tests/test_jobqueue.py run on
the port (the launcher's layouts are the GPU's, its wrapper names the
port's sampler); SlurmBackend runs against an injected fake scheduler; the
copied modules are held to their originals; checkpoints round-trip bit for
bit, a JAX state included, and write the reference's metadata; the three
tasks run through both packages' dispatch."""
import ast
import dataclasses
import json
import os
import pathlib
import time

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.harness import checkpoint as j_ckpt  # noqa: E402
from geosongpu_tpu.harness import task as j_task  # noqa: E402
from geosongpu_tpu.harness.exceptions import \
    CICheckException as JaxCheckException  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import state_from_numpy, \
    state_to_numpy  # noqa: E402
from geosongpu_tpu_torch.harness import checkpoint as t_ckpt  # noqa: E402
from geosongpu_tpu_torch.harness import task as t_task  # noqa: E402
from geosongpu_tpu_torch.harness.jobqueue import (JobQueueError,  # noqa: E402
                                                  JobState, LocalBackend,
                                                  SlurmBackend, wait_for_job)
from geosongpu_tpu_torch.harness.launcher import GPUJobConfig  # noqa: E402
from geosongpu_tpu_torch.harness.shell import (ShellScript,  # noqa: E402
                                               ShellScriptError,
                                               run_subprocess)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "geosongpu_tpu"
PORT = ROOT / "geosongpu_tpu_torch"
C8 = dict(npx=8, npz=8, dt=600.0, n_split=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's models (several test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the copies ------------------------------------------------------------

def _without_docstrings(node):
    """ast.dump of `node` with every docstring removed."""
    node = ast.parse(ast.unparse(node))
    for n in ast.walk(node):
        body = getattr(n, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            n.body = body[1:] or [ast.Pass()]
    return ast.dump(node)


def _definitions(path):
    tree = ast.parse(path.read_text())
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef))}


@pytest.mark.parametrize("module", ["harness/shell.py",
                                    "harness/tasks/heartbeat.py",
                                    "interop/argument.py",
                                    "validation/analysis.py",
                                    "validation/serialbox_binary.py",
                                    "validation/serialbox_convert.py",
                                    "plots/__init__.py", "plots/colors.py",
                                    "plots/plot_field.py",
                                    "plots/dashboard.py",
                                    "plots/dashboard_server.py",
                                    "benchmark/plots.py",
                                    "utils/project_summary.py"])
def test_copied_module_equals_the_original(module):
    """Copies differ from their originals in docstrings alone."""
    assert _without_docstrings(ast.parse((PORT / module).read_text())) == \
        _without_docstrings(ast.parse((REF / module).read_text()))


def _prog_named(path, name):
    """The file's definitions with the `prog=` of every call set to
    `name`."""
    defs = _definitions(path)
    for node in defs.values():
        for n in ast.walk(node):
            for kw in getattr(n, "keywords", ()):
                if kw.arg == "prog":
                    kw.value = ast.Constant(name)
    return defs


@pytest.mark.parametrize("module,prog", [
    ("validation/cli.py", "geosongpu-tpu-torch-validation"),
    ("plots/cli.py", "geosongpu-tpu-torch-plots")])
def test_copied_cli_equals_the_original_but_its_prog(module, prog):
    """The two CLIs differ from their originals in docstrings and in the
    program name they print."""
    port, ref = _definitions(PORT / module), _definitions(REF / module)
    progs = {kw.value.value for n in ast.walk(port["main"])
             for kw in getattr(n, "keywords", ()) if kw.arg == "prog"}
    assert progs == {prog}
    port, ref = _prog_named(PORT / module, "P"), _prog_named(REF / module, "P")
    assert port.keys() == ref.keys() == {"main"}
    assert _without_docstrings(port["main"]) == \
        _without_docstrings(ref["main"])


def test_jobqueue_shares_the_reference_local_path():
    """The states, the handle, the local backend and the poll loop are the
    reference's own code."""
    port = _definitions(PORT / "harness/jobqueue.py")
    ref = _definitions(REF / "harness/jobqueue.py")
    for name in ("JobState", "JobHandle", "JobQueueError", "LocalBackend",
                 "_default_runner", "wait_for_job"):
        assert _without_docstrings(port[name]) == \
            _without_docstrings(ref[name]), name


# ---- shell and launcher (tests/test_shell_launcher.py on the port) --------

def test_shellscript_write_execute(tmp_path):
    s = ShellScript("hello", str(tmp_path))
    s.write(["echo WORLD_$((40+2))"], exports={"FOO": "bar"})
    out = s.execute()
    assert "WORLD_42" in out
    content = open(s.path).read()
    assert "export FOO=bar" in content and "set -euo pipefail" in content


def test_shellscript_failure_raises(tmp_path):
    s = ShellScript("boom", str(tmp_path))
    s.write(["exit 3"])
    with pytest.raises(ShellScriptError):
        s.execute()
    with pytest.raises(ShellScriptError, match="command failed"):
        run_subprocess(["bash", "-c", "exit 4"])


def test_shellscript_detached_and_poll(tmp_path):
    s = ShellScript("bg", str(tmp_path))
    s.write(["sleep 0.5", "echo done"])
    pid = s.execute_detached()
    ShellScript.wait_for_pid(pid, poll_s=0.2, timeout_s=10)
    log = open(os.path.join(str(tmp_path), "bg.log")).read()
    assert "done" in log


def test_job_config_layouts_and_env():
    one = GPUJobConfig.one_gpu()
    assert one.total_gpus == 1
    node = GPUJobConfig.one_node_8gpu()
    assert node.total_gpus == 8
    two = GPUJobConfig.two_nodes_4gpu()
    assert two.total_gpus == 8
    env = two.launch_env(rank=5)
    assert env == {"MASTER_ADDR": "localhost", "MASTER_PORT": "29500",
                   "WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"}
    assert node.launch_env(3)["LOCAL_RANK"] == "3"
    # one process: no distributed env
    assert one.launch_env(0) == {}
    assert GPUJobConfig(hosts=1, gpus_per_host=1,
                        env={"A": "b"}).launch_env(0) == {"A": "b"}


def test_wrapper_script_brackets_with_sampler(tmp_path):
    cfg = GPUJobConfig(hosts=1, gpus_per_host=1, hardware_sampling=True)
    script = cfg.wrapper_script(["echo payload"], name="wrap",
                                wd=str(tmp_path))
    content = open(script.path).read()
    assert content.index("client start") < content.index("echo payload")
    assert content.index("echo payload") < content.index("client dump")
    assert content.index("client dump") < content.index("client stop")
    assert ("python -m geosongpu_tpu_torch.hws.cli server --dump_dir . "
            "--device cuda &") in content
    assert "geosongpu_tpu.hws" not in content
    # without sampling the payload runs alone
    plain = GPUJobConfig.one_gpu().wrapper_script(["echo payload"], "p",
                                                  str(tmp_path))
    out = plain.execute()
    assert out.strip() == "payload"


# ---- jobs (tests/test_jobqueue.py on the port) -----------------------------

def test_local_backend_completes(tmp_path):
    be = LocalBackend(str(tmp_path))
    h = be.submit(["echo hello", "sleep 0.3", "echo done"], "okjob")
    st = wait_for_job(be, h, poll_s=0.1, timeout_s=30)
    assert st == JobState.COMPLETED
    log = (tmp_path / "okjob.log").read_text()
    assert "hello" in log and "done" in log


def test_local_backend_failure_surfaces(tmp_path):
    be = LocalBackend(str(tmp_path))
    h = be.submit(["echo start", "false"], "failjob")
    st = wait_for_job(be, h, poll_s=0.1, timeout_s=30)
    assert st == JobState.FAILED


def test_local_backend_timeout_cancels(tmp_path):
    be = LocalBackend(str(tmp_path))
    h = be.submit(["sleep 60"], "slowjob")
    with pytest.raises(JobQueueError):
        wait_for_job(be, h, poll_s=0.1, timeout_s=0.5)
    # the cancel really killed it
    time.sleep(0.3)
    assert be.state(h) in (JobState.FAILED, JobState.COMPLETED)


class _FakeSlurm:
    """sbatch answers "4242;cluster"; sacct answers nothing (accounting
    has not seen the job), then each state of `states` in turn, the last
    one from then on."""

    def __init__(self, states=("PENDING", "RUNNING", "RUNNING",
                               "COMPLETED")):
        self.calls = []
        self.states = list(states)
        self._polls = 0

    def __call__(self, cmd):
        self.calls.append(cmd)
        if cmd[0] == "sbatch":
            return "4242;cluster\n"
        if cmd[0] == "sacct":
            assert cmd[1:] == ["-j", "4242", "-n", "-X", "-o", "State"]
            self._polls += 1
            if self._polls == 1:
                return ""
            i = min(self._polls - 2, len(self.states) - 1)
            return f"  {self.states[i]} \n"
        if cmd[0] == "scancel":
            return ""
        raise AssertionError(cmd)


def test_slurm_lifecycle(tmp_path):
    fake = _FakeSlurm()
    be = SlurmBackend(str(tmp_path), sbatch_args=["--gpus=1"], runner=fake)
    h = be.submit(["python -m geosongpu_tpu_torch.cli run --steps 2"],
                  "hsrun")
    assert h.job_id == "4242" and h.backend == "slurm"
    sbatch = fake.calls[0]
    assert sbatch[:2] == ["sbatch", "--parsable"]
    assert "--job-name=hsrun" in sbatch and "--gpus=1" in sbatch
    assert sbatch[-1] == str(tmp_path / "hsrun.sh")
    script = (tmp_path / "hsrun.sh").read_text()
    assert "python -m geosongpu_tpu_torch.cli run --steps 2" in script
    assert be.state(h) == JobState.PENDING      # not in accounting yet
    assert be.state(h) == JobState.PENDING
    assert be.state(h) == JobState.RUNNING
    assert wait_for_job(be, h, poll_s=0.01, timeout_s=10) == \
        JobState.COMPLETED
    assert not any(c[0] == "scancel" for c in fake.calls)


@pytest.mark.parametrize("raw,want", [
    ("FAILED", JobState.FAILED), ("TIMEOUT", JobState.FAILED),
    ("OUT_OF_MEMORY", JobState.FAILED), ("NODE_FAIL", JobState.FAILED),
    ("CANCELLED by 1000", JobState.CANCELLED),
    ("COMPLETED", JobState.COMPLETED)])
def test_slurm_terminal_states(tmp_path, raw, want):
    be = SlurmBackend(str(tmp_path), runner=_FakeSlurm(states=(raw,)))
    h = be.submit(["exit 1"], "bad")
    assert wait_for_job(be, h, poll_s=0.01, timeout_s=5) == want


def test_slurm_failed_submit_and_timeout_cancel(tmp_path):
    def refuse(cmd):
        raise JobQueueError(f"{' '.join(cmd)} failed: sbatch: error")

    with pytest.raises(JobQueueError, match="sbatch"):
        SlurmBackend(str(tmp_path), runner=refuse).submit(["true"], "x")
    with pytest.raises(JobQueueError, match="no job id"):
        SlurmBackend(str(tmp_path), runner=lambda cmd: "\n").submit(
            ["true"], "y")
    fake = _FakeSlurm(states=("PENDING",))
    be = SlurmBackend(str(tmp_path), runner=fake)
    h = be.submit(["sleep 600"], "stuck")
    with pytest.raises(JobQueueError, match="timed out"):
        wait_for_job(be, h, poll_s=0.01, timeout_s=0.05)
    assert fake.calls[-1] == ["scancel", "4242"]


# ---- checkpoint -------------------------------------------------------------

def _port_model():
    from geosongpu_tpu_torch.models.held_suarez import build_model

    cfg = DycoreConfig(**C8)
    return cfg, build_model(cfg, torch.device("cpu"))


def _assert_states_equal(a, b):
    a, b = state_to_numpy(a), state_to_numpy(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """4 steps straight equal, bit for bit, 2 steps, save, restore into a
    freshly built model and 2 more; mfx and mfy round-trip too."""
    cfg, model = _port_model()
    s0 = model.init(perturb=0.01)
    straight = model.run(s0, 4)

    d = str(tmp_path / "ckpts")
    s2 = model.run(s0, 2)
    path = t_ckpt.save(d, s2, cfg, step=2)
    assert os.path.isfile(os.path.join(path, "state.npz"))
    t_ckpt.save(d, model.step(s2), cfg, step=3)
    assert t_ckpt.latest_step(d) == 3
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None

    restored, step = t_ckpt.restore(d, "cpu", step=2)
    assert step == 2
    _assert_states_equal(restored, s2)
    assert float(restored.mfx.abs().max()) > 0.0
    _, fresh = _port_model()
    _assert_states_equal(fresh.run(restored, 2), straight)
    assert t_ckpt.restore(d, "cpu")[1] == 3

    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "empty"), "cpu")


def test_checkpoint_refuses_float64(tmp_path):
    cfg, model = _port_model()
    d = str(tmp_path / "c")
    path = t_ckpt.save(d, model.init(), cfg, step=0)
    arrays = dict(np.load(os.path.join(path, "state.npz")))
    arrays["pt"] = arrays["pt"].astype(np.float64)
    np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
    with pytest.raises(TypeError, match="pt is float64"):
        t_ckpt.restore(d, "cpu")


@pytest.fixture(scope="module")
def jax_state():
    from geosongpu_tpu.models.held_suarez import build_model

    cfg = JaxConfig(**C8)
    s = build_model(cfg).init(perturb=0.01)
    return cfg, s


def test_jax_state_through_port_checkpoint(jax_state, tmp_path):
    _, s = jax_state
    arrays = {f.name: np.asarray(getattr(s, f.name))
              for f in dataclasses.fields(s)}
    d = str(tmp_path / "c")
    t_ckpt.save(d, state_from_numpy(arrays, "cpu"), DycoreConfig(**C8),
                step=7)
    restored, step = t_ckpt.restore(d, "cpu")
    assert step == 7
    got = state_to_numpy(restored)
    assert sorted(got) == sorted(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)


def test_metadata_equals_reference(jax_state, tmp_path):
    jcfg, s = jax_state
    j_ckpt.save(str(tmp_path / "jax"), s, jcfg, step=5)
    _, model = _port_model()
    t_ckpt.save(str(tmp_path / "torch"), model.init(), DycoreConfig(**C8),
                step=5)
    metas = [json.loads((tmp_path / p / "meta_00000005.json").read_text())
             for p in ("jax", "torch")]
    assert metas[0] == metas[1]
    assert metas[1]["step"] == 5 and metas[1]["config"]["npx"] == 8
    assert j_ckpt.latest_step(str(tmp_path / "jax")) == \
        t_ckpt.latest_step(str(tmp_path / "torch")) == 5


# ---- Heartbeat, CIClean, CIInfo ---------------------------------------------

MAINTENANCE = ("ci-heartbeat", "ci-clean", "ci-info")


@pytest.mark.parametrize("name", MAINTENANCE)
def test_entry_equals_reference(name):
    ref = yaml.safe_load(
        (REF / "harness/data/experiments.yaml").read_text())
    assert t_task.get_config(name) == ref[name]


def _dispatch(pkg, name, tmp_path):
    """dispatch `name` in a workspace that holds a stale file: (outcome,
    env or message, the workspace's files after)."""
    ws = tmp_path / pkg / "ws"
    ws.mkdir(parents=True)
    (ws / "stale").write_text("x")
    kw = dict(artifact_directory=str(tmp_path / pkg / "art"),
              workspace=str(ws))
    try:
        if pkg == "jax":
            env = j_task.dispatch(name, "All", **kw)
        else:
            env = t_task.dispatch(name, "All", device="cpu", **kw)
    except (JaxCheckException, t_task.CICheckException) as e:
        return "CICheckException", str(e), sorted(os.listdir(ws))
    return "ok", env, sorted(os.listdir(ws))


@pytest.mark.parametrize("name", ["ci-heartbeat", "ci-info"])
def test_tasks_through_both_dispatches(name, tmp_path):
    (jo, jenv, jfiles), (to, tenv, tfiles) = (
        _dispatch(pkg, name, tmp_path) for pkg in ("jax", "torch"))
    assert jo == to == "ok"
    assert jfiles == tfiles == ["ci_metadata", "stale"]
    if name == "ci-heartbeat":
        for pkg in ("jax", "torch"):
            assert (tmp_path / pkg / "art" / "ci_metadata").is_file()
    else:
        assert tenv.get("ci_info.devices") == "cpu"
        assert jenv.exists("ci_info.devices")


def test_ci_clean_differs_on_purpose(tmp_path):
    """Both empty the workspace; the lifecycle then writes ci_metadata
    into it, which the reference's check counts against the task and the
    port's allows."""
    (jo, jmsg, jfiles), (to, _, tfiles) = (
        _dispatch(pkg, "ci-clean", tmp_path) for pkg in ("jax", "torch"))
    assert jfiles == tfiles == ["ci_metadata"]
    assert (jo, to) == ("CICheckException", "ok")
    assert "CIClean" in jmsg
    # a workspace that holds anything else fails the port's check too
    from geosongpu_tpu_torch.harness.environment import Environment
    from geosongpu_tpu_torch.harness.tasks.maintenance import CIClean

    env = Environment("ci-clean", "All", str(tmp_path))
    env.set("CI_WORKSPACE", str(tmp_path / "torch" / "ws"))
    (tmp_path / "torch" / "ws" / "left").write_text("x")
    assert not CIClean().check({}, env)


def test_ci_info_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_task.dispatch("ci-info", "All", artifact_directory=str(tmp_path),
                        workspace=str(tmp_path / "ws"), device="cuda")

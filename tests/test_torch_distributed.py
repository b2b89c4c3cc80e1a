"""The sharded step over torch.distributed: one rank per process, gloo.

Four processes (GPUJobConfig.launch_env gives each its MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK) run one step of the c8-L6
Held-Suarez model on the faces-local (2, 2) layout through
parallel/comm.ProcessGroup; the gathered global state must equal the same
step on four ranks stacked in this process bit for bit.  Two processes run
the scaling task, whose multi-rank entry only a real group reaches.  Then
parallel/mesh.py and the scaling task on one rank.  Every process is
waited on with a timeout (170 s).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from geosongpu_tpu_torch.core.config import DycoreConfig, MeshConfig
from geosongpu_tpu_torch.models.held_suarez import build_model
from geosongpu_tpu_torch.parallel.subtile import build_mesh_stepper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("u", "v", "delp", "pt", "ps", "omga")
CFG = dict(npx=8, npz=6, dt=600.0, n_split=2, halo=3)
MESH = dict(face=1, x=2, y=2)
WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from geosongpu_tpu_torch.core.config import DycoreConfig, MeshConfig
from geosongpu_tpu_torch.models.held_suarez import build_model
from geosongpu_tpu_torch.parallel import comm
from geosongpu_tpu_torch.parallel.subtile import build_mesh_stepper

cfg, mesh, out = eval(sys.argv[1]), eval(sys.argv[2]), sys.argv[3]
comm.init_from_env("gloo")
model = build_model(DycoreConfig(**cfg), "cpu")
place, step, unplace, desc = build_mesh_stepper(model, MeshConfig(**mesh))
state = unplace(step(place(model.init(perturb=1e-3))))
if torch.distributed.get_rank() == 0:
    np.savez(out, desc=desc, **{k: getattr(state, k).numpy()
                                for k in %r})
torch.distributed.destroy_process_group()
""" % (FIELDS,)
SCALING = """
import json
import sys
import torch
torch.set_num_threads(1)
from geosongpu_tpu_torch.harness.task import dispatch
from geosongpu_tpu_torch.parallel import comm

comm.init_from_env("gloo")
rank = torch.distributed.get_rank()
env = dispatch("scaling_bench", "All", artifact_directory=f"art{rank}",
               workspace=f"ws{rank}", device="cpu")
if rank == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(env.get("scaling.results"), f)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_group(tmp_path, world, argv, timeout=170):
    """Run `python -c argv...` in `world` processes of one gloo group (the
    variables of GPUJobConfig.launch_env); each must exit 0 in time."""
    from geosongpu_tpu_torch.harness.launcher import GPUJobConfig

    job = GPUJobConfig(hosts=1, gpus_per_host=world,
                       coordinator=f"localhost:{_free_port()}")
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   **job.launch_env(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c"] + argv, env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]


def test_gloo_group_step_equals_stacked_ranks(tmp_path):
    out = str(tmp_path / "gloo.npz")
    _run_group(tmp_path, 4, [WORKER, repr(CFG), repr(MESH), out])

    model = build_model(DycoreConfig(**CFG), "cpu")
    place, step, unplace, desc = build_mesh_stepper(
        model, MeshConfig(**MESH), stacked=True)
    want = unplace(step(place(model.init(perturb=1e-3))))
    got = np.load(out)
    assert str(got["desc"]) == desc == "subtile faces-local (2,2), 4 devices"
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy(),
                                      err_msg=k)


# ---- the rank grid, the transport microbenchmark, the scaling task ------

def test_make_mesh_is_the_rank_grid():
    from geosongpu_tpu_torch.parallel.mesh import make_mesh

    assert make_mesh(MeshConfig(face=6, y=1, x=1), 6).shape == (6, 1, 1)
    grid = make_mesh(MeshConfig(face=1, y=2, x=4), 8)
    assert grid.shape == (1, 2, 4) and grid[0, 1, 0] == 4
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_mesh(MeshConfig(face=1, y=2, x=4), 4)


@pytest.mark.parametrize("ranks", [1, 4])
def test_comm_microbench_on_stacked_ranks(ranks):
    from geosongpu_tpu_torch.parallel.comm import StackedGroup
    from geosongpu_tpu_torch.parallel.mesh import comm_microbench

    r = comm_microbench(StackedGroup(ranks, "cpu"), sizes_bytes=[4096, 65536],
                        repeats=2)
    assert r["sizes"] == [4096, 65536]
    assert all(g > 0 for g in r["ppermute_gbps"])
    assert all(t > 0 for t in r["psum_us"])


def test_scaling_bench_through_dispatch(tmp_path):
    """On one real rank: the one-rank entry and the loopback rows."""
    from geosongpu_tpu_torch.harness.task import dispatch

    env = dispatch("scaling_bench", "All",
                   artifact_directory=str(tmp_path / "art"),
                   workspace=str(tmp_path / "ws"), device="cpu")
    res = env.get("scaling.results")
    assert res["n_devices"] == 1
    (entry,) = res["weak_scaling"]
    assert entry["n_devices"] == 1 and entry["npx"] == 12
    assert entry["efficiency"] == 1.0 and "overlap_frac" not in entry
    assert len(res["comm"]["sizes"]) == 7
    assert (tmp_path / "art" / "scaling_bench.json").exists()


def test_process_group_needs_an_initialised_group():
    from geosongpu_tpu_torch.parallel.comm import ProcessGroup

    with pytest.raises(RuntimeError, match="initialised"):
        ProcessGroup()


def test_scaling_bench_on_a_gloo_group(tmp_path):
    """Two real ranks: the one-rank entry, then the (1, 2) entry with its
    compute-only and exchange-only legs and its overlap fraction
    (unclipped: this transport is synchronous), and the ring over the
    group."""
    out = tmp_path / "scaling.json"
    _run_group(tmp_path, 2, [SCALING, str(out)])
    res = json.loads(out.read_text())
    assert res["n_devices"] == 2
    one, two = res["weak_scaling"]
    assert (one["n_devices"], two["n_devices"]) == (1, 2)
    assert two["layout"] == [1, 2] and two["npx"] == 16
    for k in ("comm_s", "compute_s", "step_s"):
        assert two[k] > 0, k
    assert two["overlap_frac"] == ((two["comm_s"] + two["compute_s"]
                                    - two["step_s"]) / two["comm_s"])
    assert "overlap_frac_rim_split" not in two
    assert all(g > 0 for g in res["comm"]["ppermute_gbps"])

"""The port's hardware sampler and profiler modules (geosongpu_tpu_torch/hws,
benchmark/profiler.py, utils/version_checks.py, validation/run_status.py)
against the JAX package's, on the CPU:

- the energy envelope of both packages on the same uniform series, and the
  port's integral over non-uniform sample times (`t_s`);
- each package's `load_data` reads the other's npz and JSON dumps;
- the device-interval union of a synthetic torch.profiler trace and of a
  synthetic xprof trace built from the same nested and overlapping
  intervals gives the same busy time, span, duty and duty series;
- `TimedRegion`, `trace()` and `annotation`, the run record's
  configuration hash, the stack fingerprint;
- the host readings from /proc against psutil (imported here only);
- the server and client round trip on the CPU, under a short socket path;
- a sampler asked for the card with no NVML library raises.
"""
import gzip
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.hws import analysis as j_an  # noqa: E402
from geosongpu_tpu.hws import constants as j_const  # noqa: E402
from geosongpu_tpu.hws import server as j_server  # noqa: E402
from geosongpu_tpu.hws import xprof_util as j_xprof  # noqa: E402
from geosongpu_tpu.validation import run_status as j_status  # noqa: E402
from geosongpu_tpu_torch.benchmark import profiler as t_prof  # noqa: E402
from geosongpu_tpu_torch.hws import analysis as t_an  # noqa: E402
from geosongpu_tpu_torch.hws import cli as t_cli  # noqa: E402
from geosongpu_tpu_torch.hws import client as t_client  # noqa: E402
from geosongpu_tpu_torch.hws import constants as t_const  # noqa: E402
from geosongpu_tpu_torch.hws import nvml as t_nvml  # noqa: E402
from geosongpu_tpu_torch.hws import server as t_server  # noqa: E402
from geosongpu_tpu_torch.hws import xprof_util as t_xprof  # noqa: E402
from geosongpu_tpu_torch.utils import version_checks as t_ver  # noqa: E402
from geosongpu_tpu_torch.validation import run_status as t_status  # noqa: E402

FIELDS = j_server.FIELDS
META = {"device", "gpu_name", "gpu_uuid", "power_limit_w"}


def _series(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "tpu_psu": rng.uniform(60.0, 700.0, n),
        "tpu_mem_mb": rng.uniform(0.0, 8e4, n),
        "tpu_busy": rng.uniform(0.0, 1.0, n),
        "cpu_exe_utl": rng.uniform(0.0, 100.0, n),
        "cpu_psu": rng.uniform(40.0, 150.0, n),
        "host_mem_pct": rng.uniform(0.0, 100.0, n),
    }


# ---- the energy envelope --------------------------------------------------

@pytest.mark.parametrize("n,rate,start,end", [
    (2, 0.1, 0, None), (37, 0.1, 0, None), (50, 0.25, 5, 40),
    (11, 0.05, 3, None), (9, 1.0, 0, 1)])
def test_envelope_matches_reference_on_uniform_series(tmp_path, n, rate,
                                                      start, end):
    path = str(tmp_path / "hws_dump.npz")
    np.savez_compressed(path, ticks=np.asarray([1, 3]),
                        rate_s=np.asarray([rate]), **_series(n, n))
    ref = j_an.energy_envelope(j_an.load_data(path), start, end)
    got = t_an.energy_envelope(t_an.load_data(path), start, end)
    for k in ("cpu_joules", "tpu_joules", "cpu_kwh", "tpu_kwh", "total_kwh"):
        a, b = getattr(ref, k), getattr(got, k)
        assert abs(a - b) <= 1e-12 * abs(a), (k, a, b)
    assert (got.cpu_joules > 0) == (len(range(n)[start:end]) > 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_envelope_integrates_over_sample_times(seed):
    rng = np.random.default_rng(seed)
    data = {k: v for k, v in _series(25, seed).items()}
    data["rate_s"] = np.asarray([0.1])
    data["t_s"] = np.concatenate([[0.0], np.cumsum(rng.uniform(0.05, 0.8,
                                                               24))])
    rep = t_an.energy_envelope(data)
    assert rep.tpu_joules == np.trapezoid(data["tpu_psu"], x=data["t_s"])
    assert rep.cpu_joules == np.trapezoid(data["cpu_psu"], x=data["t_s"])
    # the original's fixed spacing reads another energy for the same run
    assert abs(j_an.energy_envelope(data).tpu_joules - rep.tpu_joules) \
        > 1e-3 * rep.tpu_joules


# ---- each package reads the other's dump ----------------------------------

def _jax_dump(directory):
    s = j_server.Sampler(rate_s=0.05)
    for _ in range(3):
        s.sample_once()
        s.tick()
    return s.dump(directory), s.data


def _torch_dump(directory):
    s = t_server.Sampler(rate_s=0.05, device="cpu")
    for _ in range(3):
        s.sample_once()
        s.tick()
    return s.dump(directory), s.data


@pytest.mark.parametrize("fmt", ["npz", "json"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_dump(tmp_path, monkeypatch, writer,
                                            fmt):
    monkeypatch.setattr(j_const, "DUMP_FORMAT", fmt)
    monkeypatch.setattr(t_const, "DUMP_FORMAT", fmt)
    path, data = (_jax_dump if writer == "jax" else _torch_dump)(
        str(tmp_path))
    assert path.endswith(fmt)
    ref, got = j_an.load_data(path), t_an.load_data(path)
    for k in FIELDS:
        np.testing.assert_array_equal(ref[k], np.asarray(data[k]))
        np.testing.assert_array_equal(got[k], np.asarray(data[k]))
    for d in (ref, got):
        np.testing.assert_array_equal(d["ticks"], [1, 2, 3])
        assert float(d["rate_s"][0]) == 0.05
    if writer == "torch":
        assert META <= set(got) and str(got["device"]) == "cpu"
        np.testing.assert_array_equal(got["tpu_psu"], 0.0)
        assert np.all(np.diff(got["t_s"]) > 0) and got["t_s"][0] == 0.0
        assert "energy_mj" not in got
    assert j_an.energy_envelope(ref).cpu_joules > 0
    assert t_an.energy_envelope(got).cpu_joules > 0


# ---- the device-interval union --------------------------------------------

# (start us, duration us): nested, overlapping, touching and apart
INTERVALS = {
    "nested": [(0, 100), (10, 20), (15, 5), (200, 50)],
    "overlapping": [(0, 60), (50, 60), (100, 30), (400, 10), (405, 100)],
    "touching": [(0, 10), (10, 10), (20, 10), (1000, 1)],
    "long": [(0, 250_000), (100_000, 300_000), (600_000, 120_000),
             (650_000, 10)],
    "one": [(7, 3)],
}


def _torch_trace(directory, intervals):
    os.makedirs(directory, exist_ok=True)
    ev = [{"ph": "X", "cat": "kernel" if i % 3 else "gpu_memcpy",
           "name": f"k{i}", "pid": 0, "tid": 7 + i % 2, "ts": s, "dur": d}
          for i, (s, d) in enumerate(intervals)]
    # host events and annotations over the same span are not device work
    ev += [{"ph": "X", "cat": c, "name": c, "pid": 1, "tid": 1, "ts": -50,
            "dur": 10_000_000} for c in ("cuda_runtime", "cpu_op",
                                         "gpu_user_annotation")]
    ev += [{"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
            "args": {"name": "stream 7"}}]
    with open(os.path.join(directory, "x.pt.trace.json"), "w") as f:
        json.dump({"traceEvents": ev}, f)


def _xprof_trace(directory, intervals):
    d = os.path.join(directory, "plugins", "profile", "run")
    os.makedirs(d, exist_ok=True)
    ev = [{"ph": "M", "name": "thread_name", "pid": 3, "tid": 1,
           "args": {"name": "XLA Ops"}},
          {"ph": "M", "name": "thread_name", "pid": 3, "tid": 2,
           "args": {"name": "Steps"}},
          {"ph": "X", "name": "step", "pid": 3, "tid": 2, "ts": -50,
           "dur": 10_000_000}]
    ev += [{"ph": "X", "name": f"op{i}", "pid": 3, "tid": 1, "ts": s,
            "dur": d} for i, (s, d) in enumerate(intervals)]
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": ev}, f)


@pytest.mark.parametrize("case", INTERVALS)
def test_device_busy_matches_reference(tmp_path, case):
    _torch_trace(str(tmp_path / "torch"), INTERVALS[case])
    _xprof_trace(str(tmp_path / "xprof"), INTERVALS[case])
    got = t_xprof.device_busy(str(tmp_path / "torch"))
    ref = j_xprof.device_busy(str(tmp_path / "xprof"))
    assert got == pytest.approx(ref, rel=1e-12, abs=0.0)
    assert 0.0 < got["duty"] <= 1.0
    for bucket in (1e-5, 1e-4, 0.1):
        times, duty = t_xprof.duty_series(str(tmp_path / "torch"), bucket)
        ref_times, ref_duty = j_xprof.duty_series(str(tmp_path / "xprof"),
                                                  bucket)
        assert times == ref_times
        assert duty == pytest.approx(ref_duty, rel=1e-12, abs=0.0)


def test_device_busy_newest_gz_trace_and_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_xprof.device_busy(str(tmp_path))
    _torch_trace(str(tmp_path), INTERVALS["nested"])
    time.sleep(0.01)
    with gzip.open(tmp_path / "y.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": [{"ph": "X", "cat": "kernel", "ts": 0,
                                    "dur": 4}]}, f)
    assert t_xprof.device_busy(str(tmp_path)) == {
        "busy_s": 4e-6, "span_s": 4e-6, "duty": 1.0}


# ---- profiler.py ----------------------------------------------------------

def test_timed_region_and_trace_on_cpu(tmp_path):
    timed = t_prof.TimedRegion()
    x = torch.ones(64, 64)
    with t_prof.trace(str(tmp_path), device="cpu") as prof:
        for _ in range(3):
            with timed("matmul", device="cpu"), t_prof.annotation("mm"):
                x = x @ x / 64.0
    assert len(timed.times["matmul"]) == 3
    assert timed.report().startswith("matmul: n=3 total=")
    assert any(e.name == "mm" for e in prof.events())
    path = t_xprof.newest_trace(str(tmp_path))
    assert path.endswith(".pt.trace.json") and os.path.getsize(path) > 0
    # the CPU has no device events
    assert t_xprof.device_busy(str(tmp_path)) == {
        "busy_s": 0.0, "span_s": 0.0, "duty": 0.0}


# ---- run status and the stack fingerprint ---------------------------------

@pytest.mark.parametrize("config", [None, {}, {"npx": 48, "npz": 72},
                                    {"dycore": {"dt": 600.0, "n_split": 6},
                                     "run": {"steps": 24}}])
def test_run_status_config_hash_matches_reference(config, tmp_path):
    st = t_status.capture(config, repo_dir=str(tmp_path), device="cpu")
    ref = j_status.hashlib.sha256(
        j_status.json.dumps(config or {}, sort_keys=True).encode()
    ).hexdigest()[:16]
    assert st.config_hash == ref
    assert st.git_sha == "unknown" and st.git_dirty is False
    assert st.device == "cpu" and st.torch_version == torch.__version__
    assert t_status.RunStatus.from_json(st.to_json()) == st


def test_stack_fingerprint_and_manifest(tmp_path):
    fp = t_ver.stack_fingerprint()
    assert fp["torch"] == torch.__version__ and fp["numpy"] == np.__version__
    if not torch.cuda.is_available():
        assert fp["devices"] == "cpu" and "driver" not in fp
    path = str(tmp_path / "manifest.json")
    assert t_ver.save_manifest(path) == fp
    assert t_ver.compare_with_manifest(path) == (True, [])
    with open(path, "w") as f:
        json.dump({**fp, "torch": "0.0"}, f)
    ok, diffs = t_ver.compare_with_manifest(path)
    assert not ok and diffs == [f"torch: recorded=0.0 current={fp['torch']}"]


# ---- the host readings ----------------------------------------------------

def test_host_readings_agree_with_psutil():
    psutil = pytest.importorskip("psutil")
    assert abs(t_server.host_mem_pct()
               - psutil.virtual_memory().percent) <= 2.0
    busy, total = t_server.cpu_times()
    assert 0 <= busy <= total
    s = t_server.Sampler(device="cpu")
    x = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.05:
        x += 1
    s.sample_once()
    assert 0.0 <= s.data["cpu_exe_utl"][0] <= 100.0
    spec = t_const.CPU_SPEC
    assert s.data["cpu_psu"][0] == spec["idle_w"] + s.data["cpu_exe_utl"][
        0] / 100.0 * (spec["tdp_w"] - spec["idle_w"])


# ---- the server, the client and the CLI -----------------------------------

def test_server_client_round_trip_on_cpu(tmp_path, monkeypatch):
    # a relative socket directory keeps the socket path far below 108 bytes
    monkeypatch.chdir(tmp_path)
    stale = tmp_path / "s" / "hws"
    stale.parent.mkdir()
    stale.write_text("stale")        # the server removes a stale socket
    errors = []

    def serve():
        try:
            t_server.cli("s", 0.02, "dump", "cpu")
        except BaseException as e:     # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    deadline = time.time() + 20
    while stale.is_file() or not stale.exists():
        assert time.time() < deadline and th.is_alive(), errors
        time.sleep(0.01)
    replies = [t_client.client_main("start", "s")]
    time.sleep(0.1)
    replies.append(t_client.client_main("tick", "s"))
    time.sleep(0.05)
    replies.append(t_client.client_main("dump", "s"))
    replies.append(t_client.client_main("stop", "s"))
    th.join(timeout=20)
    assert not th.is_alive() and not errors
    assert [r["status"] for r in replies] == ["ok"] * 4
    assert [r["order"] for r in replies] == ["start", "tick", "dump", "stop"]
    data = t_an.load_data(replies[2]["path"])
    assert len(data["t_s"]) >= 2 and len(data["ticks"]) == 1
    assert str(data["device"]) == "cpu"
    assert not stale.exists()
    with pytest.raises(ValueError):
        t_client.client_main("restart", "s")


def test_server_reports_a_failed_sampler(tmp_path, monkeypatch):
    """A read that fails stops the sampling; the server answers every
    later order with the failure and exits with it, instead of dumping
    a series that ends there."""
    monkeypatch.chdir(tmp_path)

    def broken():
        raise OSError("no /proc/meminfo")

    monkeypatch.setattr(t_server, "host_mem_pct", broken)
    errors = []

    def serve():
        try:
            t_server.cli("s", 0.02, "dump", "cpu")
        except OSError as e:
            errors.append(e)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    deadline = time.time() + 20
    while not (tmp_path / "s" / "hws").exists():
        assert time.time() < deadline and th.is_alive()
        time.sleep(0.01)
    assert t_client.client_main("start", "s")["status"] == "ok"
    time.sleep(0.1)
    replies = [t_client.client_main(o, "s") for o in ("tick", "dump", "stop")]
    th.join(timeout=20)
    assert not th.is_alive()
    assert [r["status"] for r in replies] == ["sampler-failed"] * 3
    assert "no /proc/meminfo" in replies[0]["error"]
    assert len(errors) == 1 and not (tmp_path / "dump").exists()


def test_cli_envelop_and_graph(tmp_path, capsys, monkeypatch):
    s = t_server.Sampler(rate_s=0.05, device="cpu")
    for _ in range(4):
        s.sample_once()
    path = s.dump(str(tmp_path))
    assert t_cli.main(["envelop", path]) == 0
    assert capsys.readouterr().out.startswith("cpu: ")
    assert t_cli.main(["envelop", path, "--data_range", "0", "1"]) == 0
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "g.png")
    assert t_cli.main(["graph", path, "--out", out]) == 0
    assert os.path.getsize(out) > 0
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    assert t_cli.main(["graph", path, "--out", out]) == 1
    assert "needs matplotlib" in capsys.readouterr().err


def test_server_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(SystemExit) as e:
        t_cli.main(["server"])
    assert e.value.code == 2


# ---- no zeros in place of the card ----------------------------------------

def test_cuda_sampler_without_nvml_raises(monkeypatch, tmp_path):
    missing = str(tmp_path / "libnvidia-ml.so.1")
    monkeypatch.setattr(t_nvml, "LIBRARY", missing)
    with pytest.raises(t_nvml.NVMLError, match="cannot load NVML"):
        t_server.Sampler(rate_s=0.1, device="cuda")
    with pytest.raises(t_nvml.NVMLError, match=missing):
        t_nvml.Device("cuda")

"""The port's plots (geosongpu_tpu_torch/plots/, benchmark/plots.py,
utils/project_summary.py, the histogram of validation/analysis.py)
against the JAX package's: the same inputs write byte-identical files in
one process; the live dashboard server re-reads its files on /reload
(tests/test_dashboard.py on the port).  matplotlib is installed here and
not on the card's machine: nothing of the port imports it on import."""
import json
import threading
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("matplotlib")

from geosongpu_tpu.benchmark import plots as j_bplots  # noqa: E402
from geosongpu_tpu.benchmark import timing as j_timing  # noqa: E402
from geosongpu_tpu.plots import cli as j_cli  # noqa: E402
from geosongpu_tpu.plots import dashboard as j_dash  # noqa: E402
from geosongpu_tpu.plots import plot_field as j_plot  # noqa: E402
from geosongpu_tpu.utils import project_summary as j_summary  # noqa: E402
from geosongpu_tpu.validation import analysis as j_analysis  # noqa: E402
from geosongpu_tpu_torch.benchmark import plots as t_bplots  # noqa: E402
from geosongpu_tpu_torch.benchmark import timing as t_timing  # noqa: E402
from geosongpu_tpu_torch.plots import cli as t_cli  # noqa: E402
from geosongpu_tpu_torch.plots import dashboard as t_dash  # noqa: E402
from geosongpu_tpu_torch.plots import plot_field as t_plot  # noqa: E402
from geosongpu_tpu_torch.plots.dashboard_server import \
    DashboardServer  # noqa: E402
from geosongpu_tpu_torch.utils import project_summary as t_summary  # noqa: E402


def _same_files(tmp_path, write):
    """write(package, directory) -> path, for "jax" and "torch"; the two
    files' bytes."""
    out = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = open(write(pkg, d), "rb").read()
    assert out["jax"] == out["torch"]
    assert len(out["torch"]) > 1000
    return out["torch"]


@pytest.mark.parametrize("diff", [False, True])
def test_plot_field_byte_identical(tmp_path, diff):
    a = np.random.default_rng(0).standard_normal((6, 8, 8, 4))
    b = a + np.random.default_rng(1).standard_normal(a.shape) * 0.1

    def write(pkg, d):
        mod = t_plot if pkg == "torch" else j_plot
        return mod.plot(a, "testvar", diff_with=b if diff else None,
                        out_png=str(d / "f.png"))

    assert _same_files(tmp_path, write)[:8] == b"\x89PNG\r\n\x1a\n"


def test_compare_dashboard_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    ref = {"pt": rng.standard_normal((6, 8, 8, 4)).astype(np.float32),
           "ps": rng.standard_normal((6, 8, 8)).astype(np.float32),
           "scalar": np.float32(1.0)}
    comp = {k: (v + 0.1 if hasattr(v, "shape") and v.ndim >= 3 else v)
            for k, v in ref.items()}

    def write(pkg, d):
        mod = t_dash if pkg == "torch" else j_dash
        return mod.compare_dashboard(ref, comp, str(d / "dash.html"))

    html = _same_files(tmp_path, write).decode()
    assert "Difference" in html and html.count("data:image/png") == 6


def _records(timing):
    rec = timing.BenchmarkRecord(
        experiment="held_suarez_c48", backend="cuda:fused",
        grid={"npx": 48, "npz": 72}, step_time_s=[0.05, 0.047, 0.049, 0.052],
        phase_tree={"full_step_ms": 50.0, "unaccounted_ms": 1.5,
                    "phases_ms": {"halo_fill (xN)": 14.5,
                                  "substep-minus-fill (xN)": 30.0,
                                  "vertical remap": 0.7,
                                  "forcing/physics": 1.4,
                                  "tracer transport": 1.9}})
    eager = timing.BenchmarkRecord(
        experiment="held_suarez_c48", backend="cuda:eager",
        grid={"npx": 48, "npz": 72}, step_time_s=[0.15, 0.14, 0.151])
    return [rec, eager]


@pytest.mark.parametrize("chart", ["step_scatter", "component_bars",
                                   "phase_sunburst"])
def test_benchmark_plots_byte_identical(tmp_path, chart):
    """Each package's charts of its own BenchmarkRecords, built from the
    same values (the JSON schema is shared)."""
    def write(pkg, d):
        mod, timing = ((t_bplots, t_timing) if pkg == "torch"
                       else (j_bplots, j_timing))
        recs = _records(timing)
        out = str(d / f"{chart}.png")
        if chart == "step_scatter":
            return mod.step_scatter(recs, out)
        if chart == "component_bars":
            return mod.component_bars(
                recs[0].phase_tree["phases_ms"], out_png=out)
        return mod.phase_sunburst(recs[0], out)

    _same_files(tmp_path, write)
    with pytest.raises(ValueError, match="phase_tree"):
        t_bplots.phase_sunburst(_records(t_timing)[1],
                                str(tmp_path / "none.png"))


def test_project_summary_byte_identical(tmp_path):
    tsv = tmp_path / "backlog.tsv"
    tsv.write_text("Title\tStatus\tDomains\n"
                   "a\topen\tdycore\n"
                   "b\tdone\tdycore,physics\n"
                   "c\topen\t\n")
    rows = t_summary.read_backlog(str(tsv))
    assert rows == j_summary.read_backlog(str(tsv))
    for col in ("Status", "Domains"):
        assert t_summary.distribution(rows, col) == \
            j_summary.distribution(rows, col)

    def write(pkg, d):
        mod = t_summary if pkg == "torch" else j_summary
        return mod.summary_plots(str(tsv), out_png=str(d / "s.png"))

    _same_files(tmp_path, write)


def test_analysis_histogram_byte_identical(tmp_path):
    rng = np.random.default_rng(4)
    ref = {"pt": rng.standard_normal((6, 8, 8, 4)).astype(np.float32)}
    comp = {"pt": ref["pt"] + rng.standard_normal((6, 8, 8, 4)).astype(
        np.float32) * 1e-3}

    def write(pkg, d):
        from geosongpu_tpu_torch.validation import analysis as t_analysis

        mod = t_analysis if pkg == "torch" else j_analysis
        out = str(d / "hist.png")
        mod.analysis(ref, comp, "pt", histogram_png=out)
        return out

    _same_files(tmp_path, write)


@pytest.mark.parametrize("cmd", ["plot", "plot_diff", "dash_compare"])
def test_plots_cli_byte_identical(tmp_path, capsys, cmd):
    rng = np.random.default_rng(2)
    pa, pb = tmp_path / "ref.npz", tmp_path / "comp.npz"
    # plot takes a time series (-st), the dashboard fields [6, y, x, ...]
    a = rng.standard_normal((2, 6, 8, 8, 3)).astype(np.float32)
    if cmd == "dash_compare":
        a = a[0]
    np.savez(pa, pt=a)
    np.savez(pb, pt=a + 0.05)

    def write(pkg, d):
        cli = t_cli if pkg == "torch" else j_cli
        if cmd == "dash_compare":
            out = str(d / "dash.html")
            argv = ["dash_compare", str(pa), str(pb), "--out", out]
        else:
            out = str(d / "pt.png")
            argv = ["plot", str(pa), "pt", "-st", "1", "-d", "3", "--out",
                    out] + (["--diff_with", str(pb)] if cmd == "plot_diff"
                            else [])
        assert cli.main(argv) == 0
        assert capsys.readouterr().out == f"wrote {out}\n"
        return out

    _same_files(tmp_path, write)


def test_live_dashboard_server_reload(tmp_path):
    """tests/test_dashboard.py::test_live_dashboard_server_reload on the
    port's server: the page, /reload after the files changed, /status."""
    rng = np.random.RandomState(3)
    a = {"pt": rng.randn(6, 8, 8).astype(np.float32)}
    pa, pb = tmp_path / "ref.npz", tmp_path / "comp.npz"
    np.savez(pa, **a)
    np.savez(pb, pt=(a["pt"] + 0.1).astype(np.float32))
    srv = DashboardServer(str(pa), str(pb), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        page1 = urllib.request.urlopen(f"{url}/", timeout=30).read().decode()
        assert "REGENERATE" in page1 and "Difference" in page1
        assert page1.count("data:image/png;base64") == 3
        np.savez(pb, pt=(a["pt"] + 5.0).astype(np.float32))
        req = urllib.request.Request(f"{url}/reload", method="POST")
        resp = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert resp["ok"] and resp["reloads"] == 2
        page2 = urllib.request.urlopen(f"{url}/", timeout=30).read().decode()
        assert page2 != page1
        status = json.loads(urllib.request.urlopen(f"{url}/status",
                                                   timeout=30).read())
        assert status["reloads"] == 2 and status["computed"] == str(pb)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{url}/nothing", timeout=30)
    finally:
        srv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()

"""The port stands on its own: no jax and nothing of the JAX package
anywhere in geosongpu_tpu_torch or chip_smoke.py (the port keeps its own
copies of the numpy core modules, tests/test_torch_core.py), and no silent
CPU fallback for the kernel path.  The scan reads the sources with `ast`;
it cannot look at sys.modules, because jax may already be loaded when the
interpreter starts."""
import ast
import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "geosongpu_tpu_torch"
ALLOWED = set()   # modules of the JAX package the port may import: none
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    """(lineno, module) for every absolute import in the file; relative
    imports are checked not to leave the package."""
    if PKG in path.parents:
        depth = len(path.relative_to(PKG).parts) - 1   # packages below PKG
    else:
        depth = -1                                     # a script: none at all
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert node.level - 1 <= depth, \
                    f"{path}:{node.lineno} relative import leaves the package"
                continue
            for alias in node.names:
                yield node.lineno, f"{node.module}.{alias.name}"


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"geosongpu_tpu_torch/" + n for n in (
        "device.py", "ops/kernels/remap.py", "dycore/sw.py",
        "dycore/nh_solver.py", "core/grid.py", "core/topology.py",
        "core/config.py", "core/vertical.py", "models/held_suarez.py",
        "cli.py", "physics/thermo.py", "physics/standalone.py",
        "physics/standalone_gate.py", "models/aquaplanet.py",
        "ops/kernels/columns.py", "ops/kernels/microphysics.py",
        "ops/kernels/standalone_twins.py", "models/baroclinic_wave.py",
        "harness/exceptions.py", "harness/progress.py",
        "harness/registry.py", "harness/environment.py", "harness/task.py",
        "harness/tasks/baroclinic.py", "hws/nvml.py", "hws/server.py",
        "hws/analysis.py", "hws/xprof_util.py", "benchmark/profiler.py",
        "utils/version_checks.py", "validation/run_status.py",
        "harness/shell.py", "harness/jobqueue.py", "harness/launcher.py",
        "harness/checkpoint.py", "harness/tasks/heartbeat.py",
        "harness/tasks/maintenance.py", "interop/__init__.py",
        "interop/argument.py", "interop/generator.py", "interop/cli.py",
        "interop/dycore.py", "ops/column_patterns.py", "ops/remap.py",
        "parallel/comm.py", "parallel/subtile.py", "parallel/mesh.py",
        "harness/tasks/scaling.py", "validation/analysis.py",
        "validation/serialbox_binary.py", "validation/serialbox_convert.py",
        "validation/cli.py", "validation/serialbox_python/serialbox.py",
        "plots/__init__.py", "plots/cli.py", "plots/colors.py",
        "plots/plot_field.py", "plots/dashboard.py",
        "plots/dashboard_server.py", "benchmark/plots.py",
        "benchmark/bounds.py", "utils/project_summary.py",
        "scripts/__init__.py", "scripts/bench_ladder.py",
        "scripts/phase_profile.py", "scripts/roofline.py",
        "scripts/hs_climatology.py")} | {
            "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(PKG).as_posix()
                         if PKG in p.parents else p.name)
def test_no_jax_and_only_numpy_reference_modules(path):
    for lineno, mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}:{lineno} imports {mod}"
        if top == "geosongpu_tpu":
            ok = any(mod == a or mod.startswith(a + ".") for a in ALLOWED)
            assert ok, f"{path}:{lineno} imports {mod} (the JAX package)"


def _module_level_imports(path: pathlib.Path):
    """(lineno, module) of the imports that run when the file is imported:
    every import outside a function body."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                for alias in node.names:
                    yield node.lineno, alias.name
            elif isinstance(node, ast.ImportFrom) and not node.level:
                yield node.lineno, node.module
            yield from walk(ast.iter_child_nodes(node))

    return walk(ast.parse(path.read_text(), str(path)).body)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(PKG).as_posix()
                         if PKG in p.parents else p.name)
def test_no_host_only_packages_at_import(path):
    """The card's machine has neither psutil nor matplotlib, and the port
    reads no YAML on its own paths: no module of the port imports psutil
    at all, and matplotlib or yaml only inside the function that draws or
    reads a YAML definition."""
    for lineno, mod in _imported_modules(path):
        assert mod.split(".")[0] != "psutil", f"{path}:{lineno} imports {mod}"
    for lineno, mod in _module_level_imports(path):
        assert mod.split(".")[0] not in ("matplotlib", "yaml"), \
            f"{path}:{lineno} imports {mod} when the module is imported"


def _no_cuda_here():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_kernel_loader_raises_without_cuda():
    _no_cuda_here()
    from geosongpu_tpu_torch.ops.kernels.build import load_library

    with pytest.raises(RuntimeError):
        load_library()


def test_make_remap_for_cuda_raises_without_cuda():
    """The kernel path never hands back the plain version for a CUDA
    device."""
    _no_cuda_here()
    from geosongpu_tpu_torch.dycore.fv_dynamics import _make_remap

    with pytest.raises(RuntimeError):
        _make_remap(DycoreConfig(remap_band=6), torch.device("cuda"))


def test_aquaplanet_kernel_path_for_cuda_raises_without_cuda():
    """pallas_microphysics on a CUDA device needs the built library: the
    model is refused where there is no card, not run on plain versions."""
    _no_cuda_here()
    from geosongpu_tpu_torch.cli import PRESETS
    from geosongpu_tpu_torch.models.aquaplanet import build_model

    small = dataclasses.replace(PRESETS["aquaplanet_c48_l32_fused"], npx=8,
                                npz=8)
    with pytest.raises(RuntimeError):
        build_model(small, torch.device("cuda"))


def test_every_kernel_source_has_a_counting_wrapper():
    """Each csrc/*.cu entry `<name>_f32` is launched by a wrapper `<name>`
    with a `launches` counter and a `<name>_plain` beside it."""
    from geosongpu_tpu_torch.ops.kernels import (columns, dsw, microphysics,
                                                 remap, standalone_twins)

    modules = (columns, dsw, microphysics, remap, standalone_twins)
    entries = set()
    for src in (PKG / "csrc").glob("*.cu"):
        entries |= set(re.findall(r'extern "C" int (\w+)_f32\(',
                                  src.read_text()))
    assert len(entries) == 15
    for name in entries:
        owners = [m for m in modules if hasattr(m, name)]
        assert len(owners) == 1, name
        assert isinstance(getattr(owners[0], name).launches, int), name
        plain = "remap_fields_banded" if name == "remap_banded" \
            else name + "_plain"
        assert hasattr(owners[0], plain), name


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    from geosongpu_tpu_torch.ops.kernels.remap import remap_banded
    from geosongpu_tpu_torch.ops.remap import remap_fields_banded

    rng = np.random.default_rng(0)
    dp = rng.uniform(0.5, 1.5, (3, 6)).astype(np.float32)
    pe1 = torch.as_tensor(np.concatenate(
        [np.zeros((3, 1), np.float32), np.cumsum(dp, -1)], -1))
    q = torch.as_tensor(rng.standard_normal((3, 6)).astype(np.float32))
    before = remap_banded.launches
    got = remap_banded([q], pe1, pe1, band=2)
    want = remap_fields_banded([q], pe1, pe1, band=2)
    assert torch.equal(got[0], want[0])
    assert remap_banded.launches == before


@pytest.mark.parametrize("change", [
    {"pallas_kt": 8},           # TPU vertical tiling
])
def test_unported_options_raise(change):
    from geosongpu_tpu_torch.dycore.fv_dynamics import check_supported

    cfg = dataclasses.replace(DycoreConfig(npx=12, npz=8), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(cfg)


@pytest.mark.parametrize("change", [
    {"hydrostatic": False},
    {"z_tracer": False},
    {"damping_exchange": "blend"},
    {"npx": 192},               # auto -> the blend form above npx 96
    {"overlap_fills": True},
    {"overlap_fills": True, "rim_split": True},
])
def test_newly_supported_options(change):
    """Options that were refused until their kernels existed: the check
    passes at the option's own size, and a step runs at c8-L4 (the blend
    form is set explicitly there: "auto" only takes it above npx 96)."""
    from geosongpu_tpu_torch.dycore.fv_dynamics import (_use_exchange,
                                                        check_supported)
    from geosongpu_tpu_torch.models.held_suarez import build_model

    cfg = dataclasses.replace(DycoreConfig(npx=12, npz=8), **change)
    check_supported(cfg)
    if change.get("npx") == 192:
        assert not _use_exchange(cfg)
        change = {"damping_exchange": "blend"}
    small = dataclasses.replace(
        DycoreConfig(npx=8, npz=4, dt=1200.0, n_split=2, pallas_dycore=True),
        **change)
    model = build_model(small, torch.device("cpu"))
    s = model.step(model.init(perturb=0.5))
    s.check_f32()
    for f in ("u", "v", "delp", "pt", "q", "w", "delz"):
        assert bool(getattr(s, f).isfinite().all()), f
    assert float(s.u.abs().max()) > 0.0
    if not small.hydrostatic:
        assert float(s.delz.min()) > 1.0 and float(s.w.abs().max()) > 0.0


def test_main_path_config_is_supported():
    from geosongpu_tpu_torch.cli import PRESETS
    from geosongpu_tpu_torch.dycore.fv_dynamics import check_supported

    assert sorted(PRESETS) == ["aquaplanet_c48_l32",
                               "aquaplanet_c48_l32_fused",
                               "held_suarez_c192_l72_fused",
                               "held_suarez_c48_l72",
                               "held_suarez_c48_l72_fused",
                               "held_suarez_c48_l72_nh_fused",
                               "jw_baroclinic_c48_l26_fused"]
    for cfg in PRESETS.values():
        assert type(cfg) is DycoreConfig
        check_supported(cfg)


def _metric_uses(name: str):
    """The PaddedMetrics fields a csrc file reads: its met(m, X, ...) uses."""
    text = (PKG / "csrc" / name).read_text()
    # met / met32 reads, metrics staged into a tile, and a field's pointer
    # handed to a stage (m.p[PHIS])
    found = re.findall(r"met(?:32)?\(m, ([A-Z0-9_]+),", text)
    found += re.findall(r"stage_metric<[^>]+>\([^,]+, m, ([A-Z0-9_]+),", text)
    found += re.findall(r"m\.p\[([A-Z][A-Z0-9_]*)\]", text)
    return {x.lower() for x in found}


def test_chip_smoke_counts_only_the_metrics_a_kernel_reads():
    """chip_smoke.py's bound counts, of the 36 metric arrays, those in its
    METRICS_READ: per kernel, over all its forms and dsw_wind's optional
    rotational damping, that is every field its own source reads, and
    nothing beyond what that source and the shared stages of
    dsw_common.cuh read."""
    from geosongpu_tpu_torch.benchmark.bounds import VTX_METRICS
    from geosongpu_tpu_torch.dycore.sw import PaddedMetrics

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.METRICS_READ) == set(smoke.OPS_PER_POINT)
    shared = _metric_uses("dsw_common.cuh")
    for kernel, (source, _, _) in smoke.KERNELS.items():
        forms = [k for k in smoke.METRICS_READ if k.split()[0] == kernel]
        assert forms, kernel
        named = set().union(*(smoke.METRICS_READ[k] for k in forms))
        assert named <= set(PaddedMetrics._fields), kernel
        if kernel == "dsw_wind":
            named |= set(VTX_METRICS)
        own = _metric_uses(source)
        assert own <= named, (kernel, sorted(own - named))
        assert named <= own | shared, (kernel, sorted(named - own - shared))
    assert not smoke.METRICS_READ["dsw_nh_pert"]
    assert "div_blend" not in smoke.METRICS_READ["dsw_wind"]

"""The port stands on its own: no jax anywhere in geosongpu_tpu_torch, only
the reference's numpy-only modules, and no silent CPU fallback for the
kernel path.  The scan reads the sources with `ast`; it cannot look at
sys.modules, because jax may already be loaded when the interpreter
starts."""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig  # noqa: E402

PKG = pathlib.Path(__file__).resolve().parents[1] / "geosongpu_tpu_torch"
ALLOWED = {
    "geosongpu_tpu.core.config",
    "geosongpu_tpu.core.topology",
    "geosongpu_tpu.core.grid",
    "geosongpu_tpu.core.vertical",
    "geosongpu_tpu.core.chart_corners",
}
SOURCES = sorted(PKG.rglob("*.py"))


def _imported_modules(path: pathlib.Path):
    """(lineno, module) for every absolute import in the file; relative
    imports are checked not to leave the package."""
    depth = len(path.relative_to(PKG).parts) - 1   # packages below the root
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
    names = {p.relative_to(PKG).as_posix() for p in SOURCES}
    assert {"device.py", "ops/kernels/remap.py", "dycore/sw.py",
            "models/held_suarez.py", "cli.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_and_only_numpy_reference_modules(path):
    for lineno, mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}:{lineno} imports {mod}"
        if top == "geosongpu_tpu":
            ok = any(mod == a or mod.startswith(a + ".") for a in ALLOWED)
            assert ok, f"{path}:{lineno} imports {mod} (not numpy-only)"


def _no_cuda_here():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_kernel_loader_raises_without_cuda():
    _no_cuda_here()
    from geosongpu_tpu_torch.ops.kernels.remap import load_library

    with pytest.raises(RuntimeError):
        load_library()


def test_make_remap_for_cuda_raises_without_cuda():
    """The kernel path never hands back the plain version for a CUDA
    device."""
    _no_cuda_here()
    from geosongpu_tpu_torch.dycore.fv_dynamics import _make_remap

    with pytest.raises(RuntimeError):
        _make_remap(DycoreConfig(remap_band=6), torch.device("cuda"))


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
    {"pallas_dycore": True},
    {"hydrostatic": False},
    {"z_tracer": False},
    {"overlap_fills": True},
    {"rim_split": True},
    {"damping_exchange": "blend"},
    {"npx": 192},               # auto -> the blend form above npx 96
])
def test_unported_options_raise(change):
    from geosongpu_tpu_torch.dycore.fv_dynamics import check_supported

    cfg = dataclasses.replace(DycoreConfig(npx=12, npz=8), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(cfg)


def test_main_path_config_is_supported():
    from geosongpu_tpu_torch.cli import PRESETS
    from geosongpu_tpu_torch.dycore.fv_dynamics import check_supported

    check_supported(PRESETS["held_suarez_c48_l72"])

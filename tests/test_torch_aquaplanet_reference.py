"""The benchmark's plain aquaplanet reference (portbench/reference) and the
program's fused aquaplanet path, each held to the reference package's
model (geosongpu_tpu/models/aquaplanet.py, its plain column functions) on
the CPU.

The configuration is the benchmark's `aquaplanet_c180` at c8-L8 (dt 300,
n_split 8, three tracers, chart corners, blend damping off at this npx).
The state is the package's initial state with 3 K of pt noise, moistened
from a seeded numpy generator (vapour up to 1.9 times its 60% start,
cloud liquid up to 3e-4 and rain up to 1e-4 kg/kg) and given seeded
winds of 5 m/s, so that the surface fluxes, the shallow convection, the
saturation adjustment, autoconversion, sedimentation and evaporation all
act.  Both paths run from it: the physics chain alone, and two whole
steps.  The package's two results are computed once (its step's
compilation is most of this file's time).

Gates, 1e-4 relative, each tracer apart: every field within 1e-4 of the
package's largest value of that field; qv, ql and qr after the chain
alone within 1e-4 of their own largest values (measured 1.4e-7, 8.3e-6,
3.1e-5).  After two steps ql and qr are held within 1e-4 of max|qv|
(measured 7.4e-6 and 1.4e-6; 6.8e-4 and 4.5e-4 of their own maxima), as
tests/test_torch_aquaplanet.py holds them: the float64 scans of the port
and of the benchmark's reference move pkz by ~1e-5 relative against the
package's triangular matmuls, and the saturation adjustment turns that
difference of vapour into condensate, 100 times smaller than the vapour
it came from.
"""
import ast
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.models import aquaplanet as jaq  # noqa: E402
from geosongpu_tpu_torch.core import state as tstate  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.models import aquaplanet as taq  # noqa: E402
from portbench.reference.core import state as rstate  # noqa: E402
from portbench.reference.core.config import \
    DycoreConfig as RefConfig  # noqa: E402
from portbench.reference.models import aquaplanet as raq  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DYCORE = dict(json.loads((ROOT / "portbench/configs/aquaplanet_c180.json")
                         .read_text())["dycore"], npx=8, npz=8)
PLAIN = dict(DYCORE, pallas_dycore=False, pallas_microphysics=False)
GATE = 1e-4
SEED = 11
TRACERS = ("qv", "ql", "qr")


def _np(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def package():
    """(start state, the package's chain alone, its two steps) as numpy."""
    jm = jaq.build_model(JaxConfig(**PLAIN))
    s = jm.init(perturb=3.0, seed=SEED)
    a = _np(s)
    rng = np.random.default_rng(SEED)
    lead = a["q"].shape[:-1]
    a["q"] = a["q"].copy()
    a["q"][..., 0] *= (1.0 + 0.9 * rng.random(lead)).astype(np.float32)
    a["q"][..., 1] = (3e-4 * rng.random(lead)).astype(np.float32)
    a["q"][..., 2] = (1e-4 * rng.random(lead)).astype(np.float32)
    for f in ("u", "v", "ua", "va"):
        a[f] = (5.0 * rng.standard_normal(a[f].shape)).astype(np.float32)
    js = dataclasses.replace(s, **{k: jnp.asarray(v) for k, v in a.items()})
    return a, _np(jax.jit(jm.physics_fn)(js)), _np(jm.run(js, 2))


def _path(name):
    """(model, numpy -> state, state -> numpy) of a path: the benchmark's
    plain reference, or the program with its fused flags (the kernels'
    plain versions on the CPU)."""
    if name == "reference":
        return (raq.build_model(RefConfig(**DYCORE), "cpu"),
                rstate.state_from_numpy, rstate.state_to_numpy)
    return (taq.build_model(DycoreConfig(**DYCORE), "cpu"),
            tstate.state_from_numpy, tstate.state_to_numpy)


def _gaps(ref, got, condensate_scale):
    """{field or tracer: max |got - ref| over its scale}."""
    out = {f: float(np.abs(got[f] - ref[f]).max() / np.abs(ref[f]).max())
           for f in ("u", "v", "pt", "delp", "ps")}
    qv_max = float(np.abs(ref["q"][..., 0]).max())
    for n, name in enumerate(TRACERS):
        scale = qv_max if n and condensate_scale == "qv" else float(
            np.abs(ref["q"][..., n]).max())
        out[name] = float(np.abs(got["q"][..., n] - ref["q"][..., n]).max()
                          / scale)
    return out


@pytest.mark.parametrize("path", ["reference", "fused"])
def test_physics_alone_held_to_the_package(package, path):
    start, ref, _ = package
    model, from_np, to_np = _path(path)
    got = to_np(model.physics(from_np(start, "cpu")))
    gaps = _gaps(ref, got, "own")
    assert max(gaps.values()) <= GATE, gaps
    assert np.array_equal(got["delp"], ref["delp"])


@pytest.mark.parametrize("path", ["reference", "fused"])
def test_two_steps_held_to_the_package(package, path):
    start, _, ref = package
    model, from_np, to_np = _path(path)
    got = to_np(model.run(from_np(start, "cpu"), 2))
    gaps = _gaps(ref, got, "qv")
    assert max(gaps.values()) <= GATE, gaps
    # the moist processes acted: cloud and rain are left
    assert got["q"][..., 1].max() > 1e-4 and got["q"][..., 2].max() > 1e-5


def _imports(path: pathlib.Path) -> set:
    """The modules `path` imports, relative imports resolved."""
    package = path.relative_to(ROOT).parent.parts
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level \
                else ()
            names.add(".".join(base + ((node.module,) if node.module
                                       else ())))
    return names


def test_the_reference_stands_alone():
    """No module of the benchmark's reference imports JAX, the JAX
    package or anything of the program (its kernels and csrc/ included)."""
    sources = sorted((ROOT / "portbench/reference").rglob("*.py"))
    assert ROOT / "portbench/reference/models/aquaplanet.py" in sources
    assert "portbench.reference.physics.thermo" in _imports(
        ROOT / "portbench/reference/models/aquaplanet.py")
    for path in sources:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "geosongpu_tpu",
                               "geosongpu_tpu_torch"), (path, name)
            assert top != "portbench" or name.startswith(
                "portbench.reference"), (path, name)

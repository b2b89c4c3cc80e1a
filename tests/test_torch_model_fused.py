"""The whole fused slice: the port's Held-Suarez model with pallas_dycore
against the JAX model with pallas_dycore=True.

c12-L8 (dt 1200, n_split 2, hord_tm 6, one tracer), the JAX state carried
across with state_from_numpy, 3 full steps (forcing and edge
symmetrization included).  On the CPU the JAX model runs its fused substep
kernels in interpret mode and its tracer subcycles in jnp
(fv_dynamics.py:150 takes dsw_tracer_acc only on a TPU; the arithmetic is
the same), and the port runs the plain versions of its CUDA kernels.
Gates as tests/test_torch_model.py: u, v within max(1e-4 x max|ref|,
6e-3 m/s); delp, pt, q, ps within 1e-4 relative.

Then the port's own gates at c8-L12 on the fused path, those of
tests/test_held_suarez.py: the rest state stays exactly at rest, pure
dynamics conserve mass; and the CPU path launches no kernel.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model as jax_model  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import dsw  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.remap import remap_banded  # noqa: E402

CPU = torch.device("cpu")
CFG = DycoreConfig(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6,
                   ntracers=1, pallas_dycore=True)
GATE = 1e-4
WIND_ATOL = 6e-3


def _np(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def reference():
    """The JAX fused model's start state (3 K of pt noise, a smooth tracer,
    one step) and its state after 3 more steps."""
    jm = jax_model(CFG)
    s = jm.init(perturb=3.0)
    rng = np.random.default_rng(5)
    q = (1.0 + 0.2 * rng.random(s.q.shape)).astype(np.float32)
    s = dataclasses.replace(s, q=jnp.asarray(q))
    s = jm.step_fn(s)
    start = _np(s)
    for _ in range(3):
        s = jm.step_fn(s)
    return start, _np(s)


def test_three_fused_steps_match_jax(reference):
    start, ref = reference
    model = build_model(CFG, CPU)
    before = [k.launches for k in dsw.KERNELS] + [remap_banded.launches]
    got = state_to_numpy(model.run(state_from_numpy(start, CPU), 3))
    assert [k.launches for k in dsw.KERNELS] + [remap_banded.launches] \
        == before
    for f in ("u", "v", "delp", "pt", "q", "ps"):
        a, b = ref[f], got[f]
        assert a.shape == b.shape and b.dtype == np.float32, f
        scale = float(np.abs(a).max())
        atol = WIND_ATOL if f in ("u", "v") else 0.0
        d = float(np.abs(a - b).max())
        assert d <= max(GATE * scale, atol), (f, d, scale)
    assert np.abs(got["u"]).max() > 0.1   # a flow, not a rest state


@pytest.fixture(scope="module")
def small_model():
    return build_model(DycoreConfig(npx=8, npz=12, dt=1200.0, n_split=6,
                                    pallas_dycore=True), CPU)


def test_fused_rest_state_stays_at_rest(small_model):
    s = small_model.dynamics(small_model.init(perturb=0.0))
    assert float(s.u.abs().max()) == 0.0
    assert float(s.v.abs().max()) == 0.0
    np.testing.assert_allclose(s.ps.numpy(), 1.0e5, rtol=1e-6)


def test_fused_mass_conservation(small_model):
    s = small_model.init(perturb=0.5)
    w = np.asarray(small_model.grid.area)[small_model.grid.interior][..., None]
    m0 = float((w * s.delp.numpy()).sum())
    for _ in range(10):
        s = small_model.dynamics(s)
    m1 = float((w * s.delp.numpy()).sum())
    assert abs(m1 - m0) / m0 < 1e-5


def test_fused_matches_eager_port_on_cpu(small_model):
    """On the CPU the fused path is the eager path's arithmetic, reordered
    into the kernels' plain versions: bit-identical states."""
    eager = build_model(dataclasses.replace(small_model.config,
                                            pallas_dycore=False), CPU)
    start = small_model.init(perturb=0.5, seed=2)
    a = state_to_numpy(small_model.run(start, 2))
    b = state_to_numpy(eager.run(start, 2))
    for f in ("u", "v", "delp", "pt", "q", "ps"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_cli_runs_fused_preset_on_cpu(capsys):
    from geosongpu_tpu_torch.cli import main

    assert main(["run", "--preset", "held_suarez_c48_l72_fused", "--npx",
                 "8", "--npz", "6", "--steps", "1", "--device", "cpu"]) == 0
    assert "ms/step" in capsys.readouterr().out

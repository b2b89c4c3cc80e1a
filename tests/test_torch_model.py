"""The whole slice: the port's Held-Suarez model against the JAX model.

c12-L8 (dt 1200, n_split 2, hord_tm 6, one tracer), the JAX state carried
across with state_from_numpy, 3 full steps (forcing and edge
symmetrization included), for remap_band 0 and 6.  Gates as
tests/test_pallas_dycore.py:89-103: u, v within max(1e-4 x max|ref|,
6e-3 m/s); delp, pt, q, ps within 1e-4 relative.

On the CPU the JAX model always remaps with the full form
(fv_dynamics.py:89 takes the Pallas banded kernel only on a TPU), while
the port with remap_band=6 runs the plain banded version of its CUDA
kernel: that case also holds the banded form to the full one on a real
trajectory.

Then the port's own gates at c8-L12, those of tests/test_held_suarez.py:
the rest state stays exactly at rest, and pure dynamics conserve mass.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model as jax_model  # noqa: E402
from geosongpu_tpu.physics import held_suarez as jhs  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.remap import remap_banded  # noqa: E402
from geosongpu_tpu_torch.physics import held_suarez as ths  # noqa: E402

CPU = torch.device("cpu")
CFG = DycoreConfig(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6,
                   ntracers=1)
GATE = 1e-4
WIND_ATOL = 6e-3


def _np(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def reference():
    """The JAX model, its start state (3 K of pt noise, a smooth tracer)
    and its state after 3 more steps."""
    jm = jax_model(CFG)
    s = jm.init(perturb=3.0)
    rng = np.random.default_rng(5)
    q = (1.0 + 0.2 * rng.random(s.q.shape)).astype(np.float32)
    s = dataclasses.replace(s, q=jnp.asarray(q))
    s = jm.step_fn(s)    # carry dynamics before the comparison starts
    start = _np(s)
    for _ in range(3):
        s = jm.step_fn(s)
    return jm, start, _np(s)


@pytest.mark.parametrize("band", [0, 6])
def test_three_steps_match_jax(reference, band):
    jm, start, ref = reference
    model = build_model(dataclasses.replace(CFG, remap_band=band), CPU)
    s = state_from_numpy(start, CPU)
    s = model.run(s, 3)
    got = state_to_numpy(s)
    for f in ("u", "v", "delp", "pt", "q", "ps"):
        a, b = ref[f], got[f]
        assert a.shape == b.shape and b.dtype == np.float32, f
        scale = float(np.abs(a).max())
        atol = WIND_ATOL if f in ("u", "v") else 0.0
        d = float(np.abs(a - b).max())
        assert d <= max(GATE * scale, atol), (f, d, scale)
    assert np.abs(got["u"]).max() > 0.1   # a flow, not a rest state


def test_held_suarez_forcing_matches_jax(reference):
    jm, start, _ = reference
    lats_j = jhs.hs_latitudes(jm.grid)
    lats_t = ths.hs_latitudes(jm.grid, CPU)
    np.testing.assert_array_equal(lats_t.lat_c.numpy(),
                                  np.asarray(lats_j.lat_c))
    args = [start[k] for k in ("u", "v", "pt", "delp")]
    ref = jhs.held_suarez_forcing(*(jnp.asarray(a) for a in args), lats_j,
                                  CFG.ptop, CFG.dt)
    got = ths.held_suarez_forcing(*(torch.from_numpy(a.copy())
                                    for a in args), lats_t, CFG.ptop, CFG.dt)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-6 * np.abs(r).max()


@pytest.fixture(scope="module")
def small_model():
    return build_model(DycoreConfig(npx=8, npz=12, dt=1200.0, n_split=6),
                       CPU)


def test_well_balanced_rest_state(small_model):
    s = small_model.dynamics(small_model.init(perturb=0.0))
    assert float(s.u.abs().max()) == 0.0
    assert float(s.v.abs().max()) == 0.0
    np.testing.assert_allclose(s.ps.numpy(), 1.0e5, rtol=1e-6)


def test_mass_conservation_pure_dynamics(small_model):
    s = small_model.init(perturb=0.5)
    w = np.asarray(small_model.grid.area)[small_model.grid.interior][..., None]
    m0 = float((w * s.delp.numpy()).sum())
    for _ in range(10):
        s = small_model.dynamics(s)
    m1 = float((w * s.delp.numpy()).sum())
    assert abs(m1 - m0) / m0 < 1e-5


def test_step_keeps_f32_and_cpu_path_launches_no_kernel(small_model):
    before = remap_banded.launches
    s = small_model.step(small_model.init(perturb=0.1, seed=3))
    s.check_f32()
    assert remap_banded.launches == before
    assert all(np.isfinite(a).all() for a in state_to_numpy(s).values())


def test_cli_runs_on_cpu(capsys):
    from geosongpu_tpu_torch.cli import main

    assert main(["run", "--npx", "8", "--npz", "6", "--steps", "1",
                 "--device", "cpu"]) == 0
    assert "ms/step" in capsys.readouterr().out

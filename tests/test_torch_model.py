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

The same 3 steps for the nonhydrostatic model with per-substep tracers
(hydrostatic=False, z_tracer=False), with and without the w sponge, and
for the blend damping form; w is gated like the winds (floor 6e-3 m/s),
delz at 1e-4 relative.  On the nonhydrostatic model: a constant tracer
stays constant (to 2e-6 relative over 3 steps: up to 2 ulp per substep and
remap), mass drift, a rest state in balance, and the state's numpy round
trip with nonzero w and delz.  Each package builds its own configuration
from one dict of keyword arguments.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model as jax_model  # noqa: E402
from geosongpu_tpu.physics import held_suarez as jhs  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.remap import remap_banded  # noqa: E402
from geosongpu_tpu_torch.physics import held_suarez as ths  # noqa: E402

CPU = torch.device("cpu")
KW = dict(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6, ntracers=1)
CFG = DycoreConfig(**KW)
GATE = 1e-4
WIND_ATOL = 6e-3


def _np(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def jax_run(kw):
    """The JAX model of kw, its start state (3 K of pt noise, a seeded
    tracer, one step) and its state after 3 more steps."""
    jm = jax_model(JaxConfig(**kw))
    s = jm.init(perturb=3.0)
    rng = np.random.default_rng(5)
    q = (1.0 + 0.2 * rng.random(s.q.shape)).astype(np.float32)
    s = dataclasses.replace(s, q=jnp.asarray(q))
    s = jm.step_fn(s)    # carry dynamics before the comparison starts
    start = _np(s)
    for _ in range(3):
        s = jm.step_fn(s)
    return jm, start, _np(s)


def assert_state_within_gates(ref, got, fields):
    for f in fields:
        a, b = ref[f], got[f]
        assert a.shape == b.shape and b.dtype == np.float32, f
        scale = float(np.abs(a).max())
        atol = WIND_ATOL if f in ("u", "v", "w") else 0.0
        d = float(np.abs(a - b).max())
        assert d <= max(GATE * scale, atol), (f, d, scale)


@pytest.fixture(scope="module")
def reference():
    return jax_run(KW)


@pytest.mark.parametrize("band", [0, 6])
def test_three_steps_match_jax(reference, band):
    jm, start, ref = reference
    model = build_model(dataclasses.replace(CFG, remap_band=band), CPU)
    s = state_from_numpy(start, CPU)
    s = model.run(s, 3)
    got = state_to_numpy(s)
    assert_state_within_gates(ref, got, ("u", "v", "delp", "pt", "q", "ps"))
    assert np.abs(got["u"]).max() > 0.1   # a flow, not a rest state


def test_held_suarez_forcing_matches_jax(reference):
    jm, start, _ = reference
    lats_j = jhs.hs_latitudes(jm.grid)
    lats_t = ths.hs_latitudes(build_model(CFG, CPU).grid, CPU)
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


# ---- nonhydrostatic, per-substep tracers, the blend form -------------------

NH_KW = dict(KW, hydrostatic=False, z_tracer=False)
NH_FIELDS = ("u", "v", "delp", "pt", "q", "ps", "w", "delz")


@pytest.mark.parametrize("w_sponge_p", [0.0, 2.0e4])
def test_three_nh_steps_match_jax(w_sponge_p):
    kw = dict(NH_KW, w_sponge_p=w_sponge_p, w_sponge_tau=1800.0)
    _, start, ref = jax_run(kw)
    got = state_to_numpy(build_model(DycoreConfig(**kw), CPU).run(
        state_from_numpy(start, CPU), 3))
    assert_state_within_gates(ref, got, NH_FIELDS)
    assert np.abs(got["w"]).max() > 1e-3 and got["delz"].min() > 1.0
    if w_sponge_p:
        # the sponge is part of what is compared: it damped w aloft
        free = state_to_numpy(build_model(DycoreConfig(**NH_KW), CPU).run(
            state_from_numpy(start, CPU), 3))
        top = np.abs(free["w"][..., 0]).max()
        assert np.abs(got["w"][..., 0]).max() < 0.9 * top


def test_three_blend_steps_match_jax():
    kw = dict(KW, damping_exchange="blend")
    _, start, ref = jax_run(kw)
    got = state_to_numpy(build_model(DycoreConfig(**kw), CPU).run(
        state_from_numpy(start, CPU), 3))
    assert_state_within_gates(ref, got, ("u", "v", "delp", "pt", "q", "ps"))


@pytest.fixture(scope="module")
def nh_model():
    return build_model(DycoreConfig(**NH_KW), CPU)


def test_nh_constant_tracer_stays_constant(nh_model):
    s = nh_model.init(perturb=3.0)
    s.q = torch.full_like(s.q, 1.5)
    s = nh_model.run(s, 3)
    assert float(s.u.abs().max()) > 0.1
    assert float((s.q - 1.5).abs().max()) <= 2e-6 * 1.5


def test_nh_mass_conservation_and_rest_state(nh_model):
    s = nh_model.dynamics(nh_model.init(perturb=0.0))
    assert float(s.u.abs().max()) == 0.0 and float(s.v.abs().max()) == 0.0
    assert float(s.w.abs().max()) < 5e-3        # balance to rounding
    np.testing.assert_allclose(s.ps.numpy(), 1.0e5, rtol=1e-6)
    s = nh_model.init(perturb=0.5)
    w = np.asarray(nh_model.grid.area)[nh_model.grid.interior][..., None]
    m0 = float((w * s.delp.numpy()).sum())
    for _ in range(10):
        s = nh_model.dynamics(s)
    m1 = float((w * s.delp.numpy()).sum())
    assert abs(m1 - m0) / m0 < 1e-5
    assert float(s.delz.min()) > 1.0 and bool(s.w.isfinite().all())


def test_state_round_trip_carries_nonzero_w_and_delz(nh_model):
    s = nh_model.run(nh_model.init(perturb=3.0), 1)
    arrays = state_to_numpy(s)
    assert np.abs(arrays["w"]).max() > 0.0 and arrays["delz"].min() > 1.0
    back = state_from_numpy(arrays, CPU)
    back.check_f32()
    for name, a in arrays.items():
        assert torch.equal(getattr(back, name), getattr(s, name)), name
        assert a.dtype == np.float32, name


@pytest.mark.parametrize("preset", ["held_suarez_c192_l72_fused",
                                    "held_suarez_c48_l72_nh_fused"])
def test_cli_runs_new_presets_on_cpu(capsys, preset):
    from geosongpu_tpu_torch.cli import main

    assert main(["run", "--preset", preset, "--npx", "8", "--npz", "6",
                 "--steps", "1", "--device", "cpu"]) == 0
    assert "ms/step" in capsys.readouterr().out

"""Port eager substep against the JAX reference at c12-L8.

Static tables: bit-exact.  Both sides cast the same f32 grid arrays and
take the same IEEE f32 reciprocals; the chart overrides are numpy on both.

Substep: the gates of tests/test_pallas_dycore.py:46-86 - 1e-4 relative,
winds with a 2e-3 m/s floor, mass fluxes 5e-3 relative.  The substep runs
as the model calls it: chart corners on, the exchange damping form with
its staggered resample tables (and the in-kernel blend as a second case),
from the same JAX-filled state.  The nonhydrostatic substep
(hydrostatic=False), the per-substep tracers (z_tracer=False) and both
together run from a JAX-filled state of the nonhydrostatic model with one
tracer, every field of SubstepOut compared: q, delz and the refills at
1e-4 relative, w like the winds (floor 2e-3 m/s).  The two packages' own
configuration and grid objects are built from one dict of keyword
arguments."""
import dataclasses


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.dycore import sw as jsw  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.grid import build_grid as torch_grid  # noqa: E402
from geosongpu_tpu_torch.dycore import sw as tsw  # noqa: E402
from geosongpu_tpu_torch.models import held_suarez as tmodel  # noqa: E402

CPU = torch.device("cpu")
KW = dict(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6)
CFG = DycoreConfig(**KW)
GATE = 1e-4
WIND_ATOL = 2e-3


@pytest.fixture(scope="module")
def models():
    """The JAX model and the port's context, each from its own package's
    configuration, grid and vertical coordinate."""
    return build_model(JaxConfig(**KW)), tmodel.build_model(CFG, CPU).ctx


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("chart_cosa", [False, True])
def test_padded_metrics_bit_exact(models, chart_cosa):
    jm, _ = models
    ref = jsw.padded_metrics(jm.grid, chart_cosa=chart_cosa)
    got = tsw.padded_metrics(torch_grid(CFG.npx, CFG.halo), CPU,
                             chart_cosa=chart_cosa)
    assert ref._fields == got._fields
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_stag_resample_tables_bit_exact(models):
    jm, _ = models
    ref = jsw.stag_resample_tables(jm.grid)
    got = tsw.stag_resample_tables(torch_grid(CFG.npx, CFG.halo), CPU)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def filled_state(models):
    jm, _ = models
    # 3 K of pt noise and 2 steps: winds of a few m/s.  Near rest (|u| ~
    # 0.01 m/s) the mass fluxes sit at the f32 noise floor of the PGF (the
    # wind floor below), and a relative flux gate measures only that noise
    s = jm.init(perturb=3.0)
    for _ in range(2):
        s = jm.step_fn(s)
    return jsw.fill_substep(jm.ctx.ops, s.u, s.v, s.delp, s.pt, None,
                            chart=jm.ctx.chart)


def test_fill_substep_matches(models, filled_state):
    jm, ctx = models
    # interiors of the JAX padded fields are the model state
    h, n = CFG.halo, CFG.npx
    u = filled_state.pu[:, h:h + n + 1, h:h + n]
    v = filled_state.pv[:, h:h + n, h:h + n + 1]
    delp = filled_state.pd_x[:, h:h + n, h:h + n]
    pt = filled_state.pt_x[:, h:h + n, h:h + n]
    got = tsw.fill_substep(ctx.ops, _t(u), _t(v), _t(delp), _t(pt),
                           chart=ctx.chart)
    for name in got._fields:
        if getattr(filled_state, name) is None:
            assert getattr(got, name) is None, name
            continue
        ref = np.asarray(getattr(filled_state, name))
        scale = float(np.abs(ref).max())
        err = float(np.abs(getattr(got, name).numpy() - ref).max())
        assert err <= 1e-6 * scale, (name, err, scale)


@pytest.mark.parametrize("damping,vtx_damp", [("exchange", 0.0),
                                              ("exchange", 0.05),
                                              ("blend", 0.0)])
def test_substep_matches_jax(models, filled_state, damping, vtx_damp):
    jm, ctx = models
    dt = CFG.dt / CFG.n_split
    exchange = damping == "exchange"
    ref = jsw.d_sw_substep(filled_state, jm.ctx.metrics, jm.ctx.ops, dt,
                           CFG.ptop, hord=CFG.hord, d2_bg=CFG.d2_bg,
                           advect_tracers=False, hord_mt=CFG.hord_mt,
                           hord_tm=CFG.hord_tm, chart=jm.ctx.chart,
                           stag_tabs=jm.ctx.stag if exchange else None,
                           vtx_damp=vtx_damp)
    s = tsw.SWState(**{f: _t(getattr(filled_state, f))
                       for f in tsw.SWState._fields})
    out = tsw.d_sw_substep(s, ctx.metrics, ctx.ops, dt, CFG.ptop,
                           hord=CFG.hord, d2_bg=CFG.d2_bg,
                           hord_mt=CFG.hord_mt, hord_tm=CFG.hord_tm,
                           chart=ctx.chart,
                           stag_tabs=ctx.stag if exchange else None,
                           vtx_damp=vtx_damp)
    for f in ("u", "v", "delp", "pt", "mfx", "mfy", "uc", "vc"):
        a = np.asarray(getattr(ref, f))
        b = getattr(out, f).numpy()
        assert a.shape == b.shape, f
        if f in ("u", "v", "uc", "vc"):
            atol, rtol = WIND_ATOL, GATE
        elif f in ("mfx", "mfy"):
            atol, rtol = 0.0, 5e-3
        else:
            atol, rtol = 0.0, GATE
        scale = float(np.abs(a).max())
        d = float(np.abs(a - b).max())
        assert d <= max(rtol * scale, atol), (f, d, scale)
    # the substep did something: winds moved off the filled state
    assert float(np.abs(out.u.numpy() - np.asarray(
        filled_state.pu)[:, 3:16, 3:15]).max()) > 0.0


# ---- nonhydrostatic substep and per-substep tracers ------------------------

NH_KW = dict(KW, ntracers=1, hydrostatic=False, z_tracer=False)


@pytest.fixture(scope="module")
def nh_models():
    return (build_model(JaxConfig(**NH_KW)),
            tmodel.build_model(DycoreConfig(**NH_KW), CPU).ctx)


@pytest.fixture(scope="module")
def nh_state(nh_models):
    """The nonhydrostatic JAX model's state after 2 steps from 3 K of pt
    noise, with a seeded tracer."""
    jm, _ = nh_models
    s = jm.init(perturb=3.0)
    rng = np.random.default_rng(5)
    q = (1.0 + 0.2 * rng.random(s.q.shape)).astype(np.float32)
    s = dataclasses.replace(s, q=jnp.asarray(q))
    for _ in range(2):
        s = jm.step_fn(s)
    return s


@pytest.mark.parametrize("nonhydro,tracers", [(True, False), (False, True),
                                              (True, True)])
def test_substep_modes_match_jax(nh_models, nh_state, nonhydro, tracers):
    jm, ctx = nh_models
    st = nh_state
    dt = CFG.dt / CFG.n_split
    filled = jsw.fill_substep(
        jm.ctx.ops, st.u, st.v, st.delp, st.pt, st.q if tracers else None,
        w=st.w if nonhydro else None, delz=st.delz if nonhydro else None,
        chart=jm.ctx.chart)
    common = dict(hord=CFG.hord, d2_bg=CFG.d2_bg, advect_tracers=tracers,
                  hord_mt=CFG.hord_mt, hord_tm=CFG.hord_tm)
    ref = jsw.d_sw_substep(filled, jm.ctx.metrics, jm.ctx.ops, dt, CFG.ptop,
                           chart=jm.ctx.chart, stag_tabs=jm.ctx.stag,
                           **common)
    s = tsw.SWState(**{f: _t(getattr(filled, f))
                       for f in tsw.SWState._fields})
    out = tsw.d_sw_substep(s, ctx.metrics, ctx.ops, dt, CFG.ptop,
                           chart=ctx.chart, stag_tabs=ctx.stag, **common)
    assert out._fields == ref._fields
    present = []
    for f in out._fields:
        a, b = getattr(ref, f), getattr(out, f)
        if a is None:
            assert b is None, f
            continue
        present.append(f)
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, f
        if f.endswith("_pad") or f.endswith("_fill"):
            a, b = a[:, 2:-2, 2:-2], b[:, 2:-2, 2:-2]
        if f in ("u", "v", "uc", "vc", "w", "uct_pad", "vct_pad"):
            atol, rtol = WIND_ATOL, GATE
        elif f.startswith("mf"):
            atol, rtol = 0.0, 5e-3
        else:
            atol, rtol = 0.0, GATE
        scale = float(np.abs(a).max())
        d = float(np.abs(a - b).max())
        assert d <= max(rtol * scale, atol), (f, d, scale)
    assert ("q" in present) == tracers
    assert ("w" in present) == ("delz" in present) == ("pz_fill" in present) \
        == nonhydro
    if nonhydro:
        # the vertical solve moved w and delz off the transported state
        assert float(np.abs(out.w.numpy() - np.asarray(st.w)).max()) > 1e-4
        assert float(out.delz.min()) >= 1.0

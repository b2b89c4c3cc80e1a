"""Port hydrostatic substep against the JAX reference at c12-L8.

Static tables: bit-exact.  Both sides cast the same f32 grid arrays and
take the same IEEE f32 reciprocals; the chart overrides are numpy on both.

Substep: the gates of tests/test_pallas_dycore.py:46-86 - 1e-4 relative,
winds with a 2e-3 m/s floor, mass fluxes 5e-3 relative.  The substep runs
as the model calls it: chart corners on, the exchange damping form with
its staggered resample tables (and the in-kernel blend as a second case),
from the same JAX-filled state."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu.dycore import sw as jsw  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.dycore import fv_dynamics as tfv  # noqa: E402
from geosongpu_tpu_torch.dycore import sw as tsw  # noqa: E402

CPU = torch.device("cpu")
CFG = DycoreConfig(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6)
GATE = 1e-4
WIND_ATOL = 2e-3


@pytest.fixture(scope="module")
def models():
    jm = build_model(CFG)
    ctx = tfv.build_context(CFG, jm.grid, np.asarray(jm.ctx.ak),
                            np.asarray(jm.ctx.bk), CPU)
    return jm, ctx


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("chart_cosa", [False, True])
def test_padded_metrics_bit_exact(models, chart_cosa):
    jm, _ = models
    ref = jsw.padded_metrics(jm.grid, chart_cosa=chart_cosa)
    got = tsw.padded_metrics(jm.grid, CPU, chart_cosa=chart_cosa)
    assert ref._fields == got._fields
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_stag_resample_tables_bit_exact(models):
    jm, _ = models
    ref = jsw.stag_resample_tables(jm.grid)
    got = tsw.stag_resample_tables(jm.grid, CPU)
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

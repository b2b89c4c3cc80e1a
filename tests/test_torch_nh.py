"""The nonhydrostatic pieces of the port against the JAX package, on the CPU.

* dycore/nh_solver.py: `_thomas` against a dense float64 solve (2e-4, the
  reference's own gate for its Thomas sweep) and against the reference's
  sweep (1e-5 relative); `full_pressure` and `hydrostatic_delz` (1e-4
  relative where the layer-mean Exner function enters - it divides a
  difference of nearly equal pk, which one ulp of pe moves by 1e-5 - and
  1e-6 for the mid pressure) and `vertical_acoustic_solve` (1e-4 relative;
  w with a floor of 1e-4 m/s, far below the 2e-3 m/s wind floor of the
  substep gates) on seeded columns; a column in discrete balance keeps
  w = 0 and p' = 0 to rounding (the properties of tests/test_nh_solver.py,
  on the port).
* dycore/sw.py at c12-L8, from a JAX-filled nonhydrostatic state with one
  tracer (3 K of pt noise, 2 steps): `nh_perturbation_fields` against the
  reference's glue form and against the TPU kernel's `_nh_pert_kernel`
  form - p' and phi' are differences of numbers near 1e5 Pa and 1e5 m2/s2
  that cancel in balance, so their gate is 1e-4 of max|ref| with a floor of
  1e-5 of the cancelling terms (1 Pa, 1 m2/s2; measured 0.58 Pa and 0.12
  m2/s2, and the reference's two forms differ by 0.2 Pa between
  themselves); rho 1e-6 relative.
  `transport_part` with w, delz and the per-substep tracer against the
  reference, 1e-5 relative over the whole padded outputs; `wind_part` with
  the p', phi', rho terms on the same inputs, the wind gate (1e-4 relative,
  2e-3 m/s floor) less the two outermost rings, as for the hydrostatic
  form (tests/test_torch_sw_fused.py).
* `dsw_tracer_plain` against the body of the TPU kernel k3b
  (sw_pallas.py:587-593: fvtp2d without the shared reciprocals, divided by
  the transported delp), 1e-5 relative; a constant tracer stays constant
  to f32 rounding (4e-7 relative, as for dsw_tracer_acc).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.dycore import nh_solver as jnh  # noqa: E402
from geosongpu_tpu.dycore import sw as jsw  # noqa: E402
from geosongpu_tpu.dycore import sw_pallas as jswp  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model as jax_model  # noqa: E402
from geosongpu_tpu.ops import fvtp2d as jfv  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.dycore import nh_solver as tnh  # noqa: E402
from geosongpu_tpu_torch.dycore import sw as tsw  # noqa: E402
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import dsw  # noqa: E402

CPU = torch.device("cpu")
KW = dict(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6, ntracers=1,
          hydrostatic=False, z_tracer=False)
DT = KW["dt"] / KW["n_split"]
PTOP = 100.0
GATE = 1e-4
WIND_ATOL = 2e-3


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _within(name, ref, got, rtol=GATE, atol=0.0):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    scale = float(np.abs(ref).max())
    d = float(np.abs(ref - got).max())
    assert d <= max(rtol * scale, atol), (name, d, scale)


# ---- nh_solver --------------------------------------------------------------

def test_thomas_against_dense_solve():
    rng = np.random.default_rng(0)
    M = 24
    a = rng.uniform(-0.3, -0.1, (8, M)).astype(np.float32)
    c = rng.uniform(-0.3, -0.1, (8, M)).astype(np.float32)
    b = (1.0 + np.abs(a) + np.abs(c)).astype(np.float32)
    d = rng.standard_normal((8, M)).astype(np.float32)
    x = tnh._thomas(*map(torch.from_numpy, (a, b, c, d))).numpy()
    assert x.shape == (8, M) and x.dtype == np.float32
    for n in range(8):
        T = (np.diag(b[n].astype(np.float64))
             + np.diag(a[n, 1:].astype(np.float64), -1)
             + np.diag(c[n, :-1].astype(np.float64), 1))
        np.testing.assert_allclose(x[n], np.linalg.solve(T, d[n]),
                                   rtol=2e-4, atol=2e-4)
    ref = np.asarray(jnh._thomas(*map(jnp.asarray, (a, b, c, d))))
    _within("thomas", ref, x, rtol=1e-5)


def _columns(K=32, ncol=(3, 5), seed=1):
    """Seeded columns: isothermal-like pt with 2 K of noise, thicknesses
    varying by 10%, delz squeezed and stretched by 5% around balance,
    interface w of 0.1 m/s."""
    rng = np.random.default_rng(seed)
    pe = np.linspace(PTOP, 1.0e5, K + 1)
    delp = np.diff(pe) * (1.0 + 0.1 * rng.uniform(-1, 1, ncol + (K,)))
    pk_mid = (0.5 * (pe[1:] + pe[:-1]) / 1e5) ** 0.2857
    pt = 280.0 / pk_mid + 2.0 * rng.standard_normal(ncol + (K,))
    w = 0.1 * rng.standard_normal(ncol + (K + 1,))
    squeeze = 1.0 + 0.05 * np.sin(np.arange(K) / 3.0)
    return (delp.astype(np.float32), pt.astype(np.float32),
            w.astype(np.float32), squeeze.astype(np.float32))


def test_full_pressure_and_hydrostatic_delz_match_reference():
    delp, pt, _, squeeze = _columns()
    ref_z = jnh.hydrostatic_delz(jnp.asarray(delp), jnp.asarray(pt), PTOP)
    got_z = tnh.hydrostatic_delz(_t(delp), _t(pt), PTOP)
    _within("hydrostatic_delz", ref_z, got_z, rtol=1e-4)
    delz = np.asarray(ref_z) * squeeze
    ref = jnh.full_pressure(jnp.asarray(delp), jnp.asarray(delz),
                            jnp.asarray(pt), PTOP)
    got = tnh.full_pressure(_t(delp), _t(delz), _t(pt), PTOP)
    for name, r, g in zip(("p_full", "p_mid_hydro", "t"), ref, got):
        _within(name, r, g, rtol=1e-6 if name == "p_mid_hydro" else 1e-4)


@pytest.mark.parametrize("dt", [60.0, 600.0])
def test_vertical_acoustic_solve_matches_reference(dt):
    delp, pt, w, squeeze = _columns()
    delz = np.asarray(jnh.hydrostatic_delz(jnp.asarray(delp),
                                           jnp.asarray(pt), PTOP)) * squeeze
    ref_w, ref_z = jnh.vertical_acoustic_solve(
        jnp.asarray(w), jnp.asarray(delz), jnp.asarray(pt),
        jnp.asarray(delp), dt, PTOP)
    got_w, got_z = tnh.vertical_acoustic_solve(_t(w), _t(delz), _t(pt),
                                               _t(delp), dt, PTOP)
    assert got_w.shape == w.shape and got_z.shape == delz.shape
    _within("w", ref_w, got_w, atol=1e-4)
    _within("delz", ref_z, got_z)
    # rigid lid and ground, and the solve did something
    assert float(got_w[..., 0].abs().max()) == 0.0
    assert float(got_w[..., -1].abs().max()) == 0.0
    assert float((got_z - _t(delz)).abs().max()) > 1.0


def test_balanced_column_keeps_w_and_pprime_zero():
    delp, pt, _, _ = _columns(seed=2)
    delp, pt = _t(delp), _t(pt)
    delz = tnh.hydrostatic_delz(delp, pt, PTOP)
    w = torch.zeros(delp.shape[:-1] + (delp.shape[-1] + 1,))
    w2, dz2 = tnh.vertical_acoustic_solve(w, delz, pt, delp, 60.0, PTOP)
    assert float(w2.abs().max()) < 5e-3
    np.testing.assert_allclose(dz2.numpy(), delz.numpy(), rtol=2e-4)
    pprime, phiprime, rho = tsw.nh_perturbation_fields(delp, pt, delz, PTOP)
    p_full, p_mid, _ = tnh.full_pressure(delp, delz, pt, PTOP)
    assert float((pprime / p_mid).abs().max()) < 1e-5
    assert float(phiprime.abs().max()) < 1e-5 * 9.80665 * float(delz.sum(-1)
                                                                .max())
    assert float(rho.min()) > 0.0


def test_column_height_conserved_by_interior_motion():
    delp, pt, _, _ = _columns(seed=3)
    delp, pt = _t(delp), _t(pt)
    delz = tnh.hydrostatic_delz(delp, pt, PTOP) * 1.02
    w = torch.zeros(delp.shape[:-1] + (delp.shape[-1] + 1,))
    h0 = delz.sum(-1)
    for _ in range(10):
        w, delz = tnh.vertical_acoustic_solve(w, delz, pt, delp, 60.0, PTOP)
    np.testing.assert_allclose(delz.sum(-1).numpy(), h0.numpy(), rtol=1e-5)


# ---- the nonhydrostatic substep's functions at c12-L8 ----------------------

@pytest.fixture(scope="module")
def models():
    return jax_model(JaxConfig(**KW)), build_model(DycoreConfig(**KW), CPU)


@pytest.fixture(scope="module")
def filled_state(models):
    jm, _ = models
    s = jm.init(perturb=3.0)
    rng = np.random.default_rng(5)
    q = (1.0 + 0.2 * rng.random(s.q.shape)).astype(np.float32)
    s = dataclasses.replace(s, q=jnp.asarray(q))
    for _ in range(2):
        s = jm.step_fn(s)
    assert float(jnp.abs(s.w).max()) > 1e-3 and float(s.delz.min()) > 1.0
    return jsw.fill_substep(jm.ctx.ops, s.u, s.v, s.delp, s.pt, s.q, w=s.w,
                            delz=s.delz, chart=jm.ctx.chart)


def _torch_state(filled_state):
    return tsw.SWState(**{f: _t(getattr(filled_state, f))
                          for f in tsw.SWState._fields})


@pytest.fixture(scope="module")
def chain(models, filled_state):
    """The JAX functions of one nonhydrostatic substep, eager: the inputs
    and outputs of the transport and of the wind update."""
    jm, _ = models
    m, ops, chart = jm.ctx.metrics, jm.ctx.ops, jm.ctx.chart
    s = filled_state
    h, n = 3, KW["npx"]
    c = {}
    uct, vct, vort, ua, va = jsw.c_sw(s, m, 0.5 * DT, PTOP, chart=chart)
    c["uct"], c["vct"], c["vort"] = uct, vct, vort
    c["div_c"] = jsw.damping_divergence(s.pu, s.pv, ua, va, uct, vct, m, ops,
                                        jm.ctx.stag)
    crx, cry = uct * DT * m.rdxc, vct * DT * m.rdyc
    xfx, yfx = uct * DT * m.dy, vct * DT * m.dx
    c["courant"] = (crx, cry, xfx, yfx)
    c["transport"] = jsw.transport_part(s, m, crx, cry, xfx, yfx, 8, True,
                                        hord_tm=KW["hord_tm"])
    delp_new, pt_new, w_adv, delz_adv, _, _ = c["transport"]

    def refill(a):
        return chart.apply_scalar(ops.fill(a[:, h:h + n, h:h + n], "x"), "x")

    zeros = jnp.zeros_like(w_adv[..., :1])
    w_if = jnp.concatenate(
        [zeros, 0.5 * (w_adv[..., :-1] + w_adv[..., 1:]), zeros], axis=-1)
    _, delz_new = jnh.vertical_acoustic_solve(w_if, delz_adv, pt_new,
                                              delp_new, DT, PTOP)
    c["delp_f"], c["pt_f"] = refill(delp_new), refill(pt_new)
    c["delz_f"] = refill(jnp.maximum(delz_new, 1.0))
    c["nh"] = jsw.nh_perturbation_fields(c["delp_f"], c["pt_f"], c["delz_f"],
                                         PTOP)
    pkz, phi = jsw._hydrostatic_fields(c["delp_f"], c["pt_f"], PTOP)
    c["pkz"], c["phi"] = pkz, phi + m.phis
    c["wind"] = jsw.wind_part(s, m, uct, vct, crx, cry, c["pt_f"], pkz,
                              c["phi"], c["nh"], DT, 8, 0.015, vort=vort,
                              div_c_in=c["div_c"])
    return c


def test_fill_substep_carries_q_w_delz(models, filled_state):
    jm, tm = models
    h, n = 3, KW["npx"]
    inner = lambda a: _t(a)[:, h:h + n, h:h + n]
    s = filled_state
    got = tsw.fill_substep(
        tm.ctx.ops, _t(s.pu)[:, h:h + n + 1, h:h + n],
        _t(s.pv)[:, h:h + n, h:h + n + 1], inner(s.pd_x), inner(s.pt_x),
        inner(s.pq_x), w=inner(s.pw_x), delz=inner(s.pz_x),
        chart=tm.ctx.chart)
    for name in got._fields:
        ref = np.asarray(getattr(s, name))
        assert getattr(got, name).shape == ref.shape, name
        _within(name, ref, getattr(got, name), rtol=1e-6)
    assert got.pq_x.shape[-1] == 1 and got.pz_y is got.pz_x


def test_nh_perturbation_fields_match_reference(chain):
    args = [chain[k] for k in ("delp_f", "pt_f", "delz_f")]
    got = tsw.nh_perturbation_fields(*map(_t, args), PTOP)
    floors = (1e-5 * 1.0e5, 1e-5 * 1.0e5, 0.0)
    for ref in (chain["nh"], jswp._nh_pert_kernel(*args, PTOP)):
        for name, r, g, floor in zip(("pprime", "phiprime", "rho"), ref, got,
                                     floors):
            _within(name, r, g, rtol=1e-6 if name == "rho" else GATE,
                    atol=floor)
    assert float(got[0].abs().max()) > 1.0    # a perturbed state


def test_nh_transport_part_matches_reference(models, filled_state, chain):
    _, tm = models
    got = tsw.transport_part(_torch_state(filled_state), tm.ctx.metrics,
                             *map(_t, chain["courant"]), 8, True,
                             hord_tm=KW["hord_tm"])
    ref = chain["transport"]
    names = ("delp_new", "pt_new", "w_adv", "delz_adv", "q_new")
    for name, r, g in zip(names, ref[:5], got[:5]):
        _within(name, r, g, rtol=1e-5)
    _within("mfx", ref[5].fx, got[5].fx, rtol=1e-5)
    _within("mfy", ref[5].fy, got[5].fy, rtol=1e-5)
    assert got[4].shape[-1] == 1 and float(got[3].min()) >= 1.0


def test_nh_wind_part_matches_reference(models, filled_state, chain):
    _, tm = models
    t = lambda k: _t(chain[k])
    crx, cry = (_t(a) for a in chain["courant"][:2])
    nh = tuple(_t(a) for a in chain["nh"])
    args = (_torch_state(filled_state), tm.ctx.metrics, t("uct"), t("vct"),
            crx, cry, t("pt_f"), t("pkz"), t("phi"))
    got = tsw.wind_part(*args, nh, DT, 8, 0.015, vort=t("vort"),
                        div_c_in=t("div_c"))
    hydro = tsw.wind_part(*args, None, DT, 8, 0.015, vort=t("vort"),
                          div_c_in=t("div_c"))
    for name, r, g, g0 in zip(("u", "v"), chain["wind"], got, hydro):
        r, g, g0 = (np.asarray(a)[:, 2:-2, 2:-2] for a in (r, g, g0))
        _within(name, r, g, atol=WIND_ATOL)
        # the nonhydrostatic terms are part of what is compared
        assert float(np.abs(g - g0).max()) > 10 * WIND_ATOL, name


def test_dsw_nh_wind_plain_matches_reference(models, filled_state, chain):
    """dsw_wind_plain with delz_f: the column stages and the wind update
    as the nonhydrostatic kernel composes them."""
    _, tm = models
    s = _torch_state(filled_state)
    t = lambda k: _t(chain[k])
    got = dsw.dsw_wind_plain(s.pu, s.pv, t("uct"), t("vct"), t("delp_f"),
                             t("pt_f"), t("vort"), t("div_c"), tm.ctx.metrics,
                             PTOP, DT, 8, 0.015, 0.0, t("delz_f"))
    for name, r, g in zip(("u", "v"), chain["wind"], got):
        _within(name, np.asarray(r)[:, 2:-2, 2:-2], g[:, 2:-2, 2:-2],
                atol=WIND_ATOL)


def test_dsw_tracer_plain_matches_k3b_body(models, filled_state, chain):
    jm, tm = models
    s, m = filled_state, jm.ctx.metrics
    crx, cry, xfx, yfx = chain["courant"]
    delp_new, mf = chain["transport"][0], chain["transport"][5]
    h, n = 3, KW["npx"]

    def k3b(qx):
        qf = jfv.fvtp2d(qx, qx, crx, cry, xfx, yfx, m.area, hord=8,
                        mfx=mf.fx, mfy=mf.fy)
        return (qx * s.pd_x + (jfv.ddx(qf.fx) + jfv.ddy(qf.fy)) * m.rarea) \
            / delp_new

    qx = s.pq_x[..., 0]
    const = jnp.full_like(qx, 1.5)
    args = lambda q: (_t(q), _t(q), _t(s.pd_x), _t(delp_new),
                      _t(chain["uct"]), _t(chain["vct"]), _t(mf.fx),
                      _t(mf.fy), tm.ctx.metrics, DT, 8)
    (got,) = dsw.dsw_tracer_plain(*args(qx))
    _within("q", k3b(qx), got, rtol=1e-5)
    # and against the eager transport's tracer (reciprocal form): rounding
    _within("q vs transport_part", chain["transport"][4][..., 0], got,
            rtol=1e-5)
    (flat,) = dsw.dsw_tracer_plain(*args(const))
    inner = flat[:, h:h + n, h:h + n]
    assert float((inner - 1.5).abs().max()) <= 4e-7 * 1.5

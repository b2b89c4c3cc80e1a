"""The port's fused substep path against the JAX package's, at c12-L8.

On the CPU every kernel wrapper of the port runs its plain PyTorch version,
and the JAX package runs its Pallas kernels in interpret mode, as its own
tests do (tests/test_pallas_dycore.py).  From the JAX-filled state of
tests/test_torch_sw.py (3 K of pt noise, 2 steps):

* d_sw_substep_fused against d_sw_substep_pallas(interpret=True), chart
  corners and the exchange damping form, vtx_damp 0 and 0.05: the gates
  of tests/test_torch_sw.py - 1e-4 relative, winds with a 2e-3 m/s floor,
  mass fluxes 5e-3 - on the interiors, and on the padded uct/vct/mfx/mfy
  that feed the tracer transport less their two outermost rings: those
  are built from edge-replicated, chart-resampled halo values, where the
  column-sum rounding between the two packages (the wind floor) reaches
  1.4e-2 m/s in uct (measured; the same against the eager JAX substep).
  Kernel and plain version agree over the whole padded arrays
  (tests/test_torch_cuda.py, chip_smoke.py);
* each kernel's plain version against the JAX functions it replaces, on
  the same inputs: 1e-5 relative over the whole padded outputs for
  dsw_csw1 and dsw_transport; for dsw_csw2 and dsw_wind, which integrate
  columns, the wind gate less the two outermost rings (as above); the
  column integral against the TPU kernel's (_hydro_fields_kernel) at 1e-5
  relative;
* tracer_interval_advect with two tracers against
  tracer_interval_advect_pallas(interpret=True) at 1e-4 relative; a
  constant tracer stays constant to f32 rounding (4e-7 relative, the
  package's own figure: the PPM edge weights 7/12 and 1/12 are not exact
  in f32, so a constant moves by up to 2 ulp);
* on the CPU every wrapper is its plain version and no launch counter
  moves;
* the blend damping form (stag_tabs=None: dsw_wind computes the damping
  divergence itself), the nonhydrostatic substep, the per-substep tracers
  (dsw_tracer) and both together, each against
  d_sw_substep_pallas(interpret=True) in the same mode, every field of
  SubstepOut: the gates above, q, delz and the refills at 1e-4 relative,
  w like the winds.  In interpret mode the JAX substep takes the glue form
  nh_perturbation_fields where the compiled TPU kernel runs
  _nh_pert_kernel (sw_pallas.py:508); tests/test_torch_nh.py holds the
  port to both.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.dycore import sw as jsw  # noqa: E402
from geosongpu_tpu.dycore import sw_pallas as jswp  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.dycore import sw as tsw  # noqa: E402
from geosongpu_tpu_torch.dycore.sw_fused import (  # noqa: E402
    d_sw_substep_fused, tracer_interval_advect)
from geosongpu_tpu_torch.models import held_suarez as tmodel  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import dsw  # noqa: E402

CPU = torch.device("cpu")
KW = dict(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6, pallas_dycore=True)
CFG = DycoreConfig(**KW)
DT = CFG.dt / CFG.n_split
GATE = 1e-4
WIND_ATOL = 2e-3
WINDS = ("u", "v", "uc", "vc", "uct_pad", "vct_pad")
FLUXES = ("mfx", "mfy", "mfx_pad", "mfy_pad")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _within(name, ref, got, rtol=GATE, atol=0.0):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    scale = float(np.abs(ref).max())
    d = float(np.abs(ref - got).max())
    assert d <= max(rtol * scale, atol), (name, d, scale)


@pytest.fixture(scope="module")
def models():
    return build_model(JaxConfig(**KW)), tmodel.build_model(CFG, CPU).ctx


@pytest.fixture(scope="module")
def filled_state(models):
    jm, _ = models
    s = jm.init(perturb=3.0)
    for _ in range(2):
        s = jm.step_fn(s)
    return jsw.fill_substep(jm.ctx.ops, s.u, s.v, s.delp, s.pt, None,
                            chart=jm.ctx.chart)


@pytest.fixture(scope="module")
def chain(models, filled_state):
    """The JAX glue and functions of one substep (jnp, no Pallas):
    {name: array} with every kernel's inputs and the JAX functions'
    outputs."""
    jm, _ = models
    m, ops, chart = jm.ctx.metrics, jm.ctx.ops, jm.ctx.chart
    s = filled_state
    h, n = CFG.halo, CFG.npx
    c = {}
    ua, va = jsw.a_grid_winds(s.pu, s.pv, m)
    c["ua"], c["va"] = chart.apply_agrid(ua, va, s.pu, s.pv)
    c["csw1"] = jsw.c_sw_part1(s, m, 0.5 * DT, c["ua"], c["va"])
    uc, vc, delp_h, pt_h, ke, vort = c["csw1"]
    c["vort"] = chart.apply_scalar(vort, "derived")
    pkz, phi = jsw._hydrostatic_fields(delp_h, pt_h, CFG.ptop)
    c["csw2"] = jsw.c_sw_part2(uc, vc, pt_h, pkz, phi + m.phis, ke,
                               c["vort"], m, 0.5 * DT)
    uct, vct = c["csw2"]
    c["div_c"] = jsw.damping_divergence(s.pu, s.pv, c["ua"], c["va"], uct,
                                        vct, m, ops, jm.ctx.stag)
    crx, cry = uct * DT * m.rdxc, vct * DT * m.rdyc
    xfx, yfx = uct * DT * m.dy, vct * DT * m.dx
    delp_new, pt_new, _, _, _, mf = jsw.transport_part(
        s, m, crx, cry, xfx, yfx, CFG.hord, False, hord_tm=CFG.hord_tm)
    c["transport"] = (delp_new, pt_new, mf.fx, mf.fy)

    def refill(a):
        return chart.apply_scalar(ops.fill(a[:, h:h + n, h:h + n], "x"), "x")

    c["delp_f"], c["pt_f"] = refill(delp_new), refill(pt_new)
    pkz, phi = jsw._hydrostatic_fields(c["delp_f"], c["pt_f"], CFG.ptop)
    c["wind"] = jsw.wind_part(s, m, uct, vct, crx, cry, c["pt_f"], pkz,
                              phi + m.phis, None, DT, CFG.hord, CFG.d2_bg,
                              hord_mt=CFG.hord_mt, vort=c["vort"],
                              div_c_in=c["div_c"])
    return c


def _port_args(name, s, chain, m):
    """The port's arguments of kernel `name`, from the JAX chain."""
    t = lambda k: _t(chain[k])
    uct, vct = (_t(a) for a in chain["csw2"])
    if name == "dsw_csw1":
        return (s.pu, s.pv, t("ua"), t("va"), s.pd_x, s.pd_y, s.pt_x,
                s.pt_y, m, 0.5 * DT)
    if name == "dsw_csw2":
        uc, vc, delp_h, pt_h, ke, _ = (_t(a) for a in chain["csw1"])
        return (uc, vc, delp_h, pt_h, ke, t("vort"), m, CFG.ptop, 0.5 * DT)
    if name == "dsw_transport":
        return (s.pd_x, s.pd_y, s.pt_x, s.pt_y, uct, vct, m, DT, CFG.hord_tm)
    if name == "dsw_nh_pert":
        # any positive thickness will do for a wrapper check
        return (t("delp_f"), t("pt_f"), t("delp_f") * 0.08, CFG.ptop)
    if name == "dsw_wind":
        return (s.pu, s.pv, uct, vct, t("delp_f"), t("pt_f"), t("vort"),
                t("div_c"), m, CFG.ptop, DT, CFG.hord_mt or CFG.hord,
                CFG.d2_bg, 0.0)
    qx = s.pt_x / 300.0
    mfx, mfy = (_t(a) for a in chain["transport"][2:])
    if name == "dsw_tracer":
        return (qx, qx, s.pd_x, _t(chain["transport"][0]), uct, vct, mfx,
                mfy, m, DT, CFG.hord)
    return (qx, qx, s.pd_x, uct, vct, mfx, mfy, m, DT, CFG.hord)


def _torch_state(filled_state):
    return tsw.SWState(**{f: _t(getattr(filled_state, f))
                          for f in tsw.SWState._fields})


@pytest.mark.parametrize("vtx_damp", [0.0, 0.05])
def test_fused_substep_matches_jax_pallas(models, filled_state, vtx_damp):
    jm, ctx = models
    ref = jswp.d_sw_substep_pallas(
        filled_state, jm.ctx.metrics, jm.ctx.ops, DT, CFG.ptop,
        hord=CFG.hord, d2_bg=CFG.d2_bg, advect_tracers=False,
        hord_mt=CFG.hord_mt, hord_tm=CFG.hord_tm, interpret=True,
        chart=jm.ctx.chart, stag_tabs=jm.ctx.stag, vtx_damp=vtx_damp)
    out = d_sw_substep_fused(_torch_state(filled_state), ctx.metrics,
                             ctx.ops, DT, CFG.ptop, hord=CFG.hord,
                             d2_bg=CFG.d2_bg, hord_mt=CFG.hord_mt,
                             hord_tm=CFG.hord_tm, chart=ctx.chart,
                             stag_tabs=ctx.stag, vtx_damp=vtx_damp)
    for f in ("u", "v", "delp", "pt", "uc", "vc") + FLUXES + WINDS[4:]:
        r, g = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        if f.endswith("_pad"):
            r, g = r[:, 2:-2, 2:-2], g[:, 2:-2, 2:-2]
        if f in WINDS:
            _within(f, r, g, atol=WIND_ATOL)
        elif f in FLUXES:
            _within(f, r, g, rtol=5e-3)
        else:
            _within(f, r, g)
    # the substep moved the winds off the filled state
    assert float(np.abs(out.u.numpy() - np.asarray(
        filled_state.pu)[:, 3:16, 3:15]).max()) > 0.0


@pytest.mark.parametrize("name", ["dsw_csw1", "dsw_csw2", "dsw_transport",
                                  "dsw_wind"])
def test_plain_kernel_matches_jax_functions(models, filled_state, chain,
                                            name):
    """Each plain version against the JAX functions of the kernel body,
    fed the same inputs; csw2 and wind integrate columns (torch.cumsum
    against the reference's triangular matmul), hence their wind floor."""
    _, ctx = models
    ref = chain[{"dsw_csw1": "csw1", "dsw_csw2": "csw2",
                 "dsw_transport": "transport", "dsw_wind": "wind"}[name]]
    args = _port_args(name, _torch_state(filled_state), chain, ctx.metrics)
    got = getattr(dsw, name + "_plain")(*args)
    assert len(got) == len(ref)
    for n, (r, g) in enumerate(zip(ref, got)):
        if name in ("dsw_csw2", "dsw_wind"):
            r, g = np.asarray(r)[:, 2:-2, 2:-2], g[:, 2:-2, 2:-2]
            _within(f"{name}[{n}]", r, g, atol=WIND_ATOL)
        else:
            _within(f"{name}[{n}]", r, g, rtol=1e-5)


def test_column_integral_matches_tpu_kernel_form(chain):
    """The port's column integral (pow and log, torch.cumsum) against the
    TPU kernel's (exp(kappa (ln pe - ln P00)), lane cumsum)."""
    ref = jswp._hydro_fields_kernel(chain["delp_f"], chain["pt_f"], CFG.ptop)
    got = tsw._hydrostatic_fields(_t(chain["delp_f"]), _t(chain["pt_f"]),
                                  CFG.ptop)
    for name, r, g in zip(("pkz", "phi"), ref, got):
        _within(name, r, g, rtol=1e-5)


def test_tracer_subcycle_matches_jax_pallas(models, filled_state, chain):
    jm, ctx = models
    s = filled_state
    h, n = CFG.halo, CFG.npx
    rng = np.random.default_rng(7)
    q = (1.0 + 0.2 * rng.random(s.pd_x[:, h:h + n, h:h + n].shape)
         ).astype(np.float32)
    qx = np.asarray(jm.ctx.chart.apply_scalar(
        jm.ctx.ops.fill(jnp.asarray(q), "x"), "x"))
    const = np.full_like(qx, 1.5)
    uct, vct = chain["csw2"]
    mfx, mfy = chain["transport"][2:]
    ref_d, ref_q = jswp.tracer_interval_advect_pallas(
        [jnp.asarray(qx), jnp.asarray(const)],
        [jnp.asarray(qx), jnp.asarray(const)], s.pd_x, uct, vct, DT, mfx,
        mfy, jm.ctx.metrics, CFG.hord, interpret=True)
    qs = [_t(qx), _t(const)]
    before = [k.launches for k in dsw.KERNELS]
    got_d, got_q = tracer_interval_advect(qs, qs, _t(s.pd_x), _t(uct),
                                          _t(vct), DT, _t(mfx), _t(mfy),
                                          ctx.metrics, CFG.hord)
    assert [k.launches for k in dsw.KERNELS] == before
    _within("delp", ref_d, got_d)
    for t, (r, g) in enumerate(zip(ref_q, got_q)):
        _within(f"q[{t}]", r, g)
    inner = got_q[1][:, h:h + n, h:h + n]
    assert float((inner - 1.5).abs().max()) <= 4e-7 * 1.5


@pytest.mark.parametrize("name", [k.__name__ for k in dsw.KERNELS])
def test_cpu_wrapper_runs_plain_and_counts_nothing(models, filled_state,
                                                   chain, name):
    _, ctx = models
    args = _port_args(name, _torch_state(filled_state), chain, ctx.metrics)
    kern = getattr(dsw, name)
    before = kern.launches
    got = kern(*args)
    want = getattr(dsw, name + "_plain")(*args)
    assert kern.launches == before
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_blend_damping_form_matches_reference(models, filled_state, chain):
    """With div_c=None the wrapper takes the blend damping form, which
    differs from the exchange form and agrees with the reference's wind_part
    in the blend form (the wind gate, less the two outermost rings)."""
    jm, ctx = models
    args = list(_port_args("dsw_wind", _torch_state(filled_state), chain,
                           ctx.metrics))
    exchange = dsw.dsw_wind(*args)
    args[7] = None
    got = dsw.dsw_wind(*args)
    m = jm.ctx.metrics
    uct, vct = chain["csw2"]
    pkz, phi = jsw._hydrostatic_fields(chain["delp_f"], chain["pt_f"],
                                       CFG.ptop)
    ref = jsw.wind_part(filled_state, m, uct, vct, uct * DT * m.rdxc,
                        vct * DT * m.rdyc, chain["pt_f"], pkz, phi + m.phis,
                        None, DT, CFG.hord, CFG.d2_bg, hord_mt=CFG.hord_mt,
                        vort=chain["vort"], div_c_in=None)
    for name, r, g, e in zip(("u", "v"), ref, got, exchange):
        _within(name, np.asarray(r)[:, 2:-2, 2:-2], g[:, 2:-2, 2:-2],
                atol=WIND_ATOL)
        assert float((g - e).abs().max()) > 0.0, name


# ---- the blend form, the nonhydrostatic substep, per-substep tracers -------

NH_KW = dict(KW, ntracers=1, hydrostatic=False, z_tracer=False)
MODES = {   # mode -> (nonhydrostatic, per-substep tracers, exchange form)
    "blend": (False, False, False),
    "nh": (True, False, True),
    "tracers": (False, True, True),
    "nh+tracers": (True, True, True),
    "nh+tracers+blend": (True, True, False),
}


@pytest.fixture(scope="module")
def nh_models():
    return (build_model(JaxConfig(**NH_KW)),
            tmodel.build_model(DycoreConfig(**NH_KW), CPU).ctx)


@pytest.fixture(scope="module")
def nh_state(nh_models):
    jm, _ = nh_models
    s = jm.init(perturb=3.0)
    rng = np.random.default_rng(5)
    q = (1.0 + 0.2 * rng.random(s.q.shape)).astype(np.float32)
    s = dataclasses.replace(s, q=jnp.asarray(q))
    for _ in range(2):
        s = jm.step_fn(s)
    return s


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_substep_modes_match_jax_pallas(nh_models, nh_state, mode):
    nonhydro, tracers, exchange = MODES[mode]
    jm, ctx = nh_models
    st = nh_state
    filled = jsw.fill_substep(
        jm.ctx.ops, st.u, st.v, st.delp, st.pt, st.q if tracers else None,
        w=st.w if nonhydro else None, delz=st.delz if nonhydro else None,
        chart=jm.ctx.chart)
    common = dict(hord=CFG.hord, d2_bg=CFG.d2_bg, advect_tracers=tracers,
                  hord_mt=CFG.hord_mt, hord_tm=CFG.hord_tm)
    ref = jswp.d_sw_substep_pallas(
        filled, jm.ctx.metrics, jm.ctx.ops, DT, CFG.ptop, interpret=True,
        chart=jm.ctx.chart, stag_tabs=jm.ctx.stag if exchange else None,
        **common)
    before = [k.launches for k in dsw.KERNELS]
    out = d_sw_substep_fused(
        _torch_state(filled), ctx.metrics, ctx.ops, DT, CFG.ptop,
        chart=ctx.chart, stag_tabs=ctx.stag if exchange else None, **common)
    assert [k.launches for k in dsw.KERNELS] == before
    assert out._fields == ref._fields
    for f in out._fields:
        r, g = getattr(ref, f), getattr(out, f)
        if r is None:
            assert g is None, f
            continue
        r, g = np.asarray(r), g.numpy()
        if f.endswith("_pad") or f.endswith("_fill"):
            r, g = r[:, 2:-2, 2:-2], g[:, 2:-2, 2:-2]
        if f in WINDS or f == "w":
            _within(f, r, g, atol=WIND_ATOL)
        elif f in FLUXES:
            _within(f, r, g, rtol=5e-3)
        else:
            _within(f, r, g)
    assert (out.q is not None) == tracers
    assert (out.w is not None) == (out.delz is not None) == nonhydro


def test_substep_kernel_args_records_the_new_kernels(nh_models, nh_state):
    """substep_kernel_args hands a kernel check the arguments of every
    kernel the substep's mode runs, and runs the plain versions itself."""
    from geosongpu_tpu_torch.dycore.sw_fused import substep_kernel_args

    _, ctx = nh_models
    st = nh_state
    s = tsw.fill_substep(ctx.ops, _t(st.u), _t(st.v), _t(st.delp), _t(st.pt),
                         _t(st.q), w=_t(st.w), delz=_t(st.delz),
                         chart=ctx.chart)
    args, out = substep_kernel_args(s, ctx.metrics, ctx.ops, DT, CFG.ptop,
                                    hord_tm=CFG.hord_tm, chart=ctx.chart,
                                    stag_tabs=None)
    assert sorted(args) == ["dsw_csw1", "dsw_csw2", "dsw_nh_pert",
                            "dsw_tracer", "dsw_transport", "dsw_wind"]
    assert args["dsw_wind"][7] is None            # the blend form
    assert args["dsw_wind"][14] is args["dsw_nh_pert"][2]
    assert len(args["dsw_transport"][9]) == 4     # pw_x, pw_y, pz_x, pz_y
    ref = d_sw_substep_fused(s, ctx.metrics, ctx.ops, DT, CFG.ptop,
                             hord_tm=CFG.hord_tm, chart=ctx.chart,
                             stag_tabs=None)
    for f in ("u", "v", "delp", "pt", "q", "w", "delz"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f

"""Tests that need an NVIDIA card: the CUDA kernels (remap_banded and the
fused substep kernels, in every form: hydrostatic, nonhydrostatic, blend)
against their plain PyTorch versions, their input checks, and the port's
model on the card against the CPU: eager, fused, nonhydrostatic with
per-substep tracers, and the blend damping form.  They skip without CUDA.
This file imports no jax, so on the card's machine it runs on its own:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.dycore.fv_dynamics import \
    _use_exchange  # noqa: E402
from geosongpu_tpu_torch.dycore.sw import (PaddedMetrics,  # noqa: E402
                                           fill_substep)
from geosongpu_tpu_torch.dycore.sw_fused import \
    substep_kernel_args  # noqa: E402
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.ops import remap as tremap  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import dsw  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.dsw import METRIC_STAGGER  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.remap import remap_banded  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _column(lead, K, band, seed):
    """(pe1, pe2, fields): pe2 displaced smoothly by up to 0.9 x band/2
    layers (interfaces at fractional source index k + a sin(pi k / K)),
    so target layers stay comparable to source layers; a sorted random
    displacement makes near-empty target layers, whose f32 remap is
    ill-conditioned (the plain f32 version then differs from f64 by ~1e-4
    relative)."""
    rng = np.random.default_rng(seed)
    dp1 = rng.uniform(0.5, 1.5, lead + (K,))
    pe1 = np.concatenate([np.zeros(lead + (1,)), np.cumsum(dp1, -1)], -1)
    amp = rng.uniform(-1.0, 1.0, lead + (1,)) * 0.45 * min(band, K - 1)
    k = np.arange(K + 1)
    x = k + amp * np.sin(np.pi * k / K)
    idx = np.clip(np.floor(x).astype(int), 0, K - 1)
    pe2 = (np.take_along_axis(pe1, idx, -1)
           + (x - idx) * np.take_along_axis(dp1, idx, -1))
    pe2[..., 0], pe2[..., -1] = pe1[..., 0], pe1[..., -1]
    qs = [(100.0 * (rng.standard_normal(lead + (K,)) + 5.0)).astype(np.float32)
          for _ in range(4)]
    return pe1.astype(np.float32), pe2.astype(np.float32), qs


@pytest.mark.parametrize("lead,K,n,band", [((6, 7, 5), 16, 2, 6),
                                           ((6, 6, 7), 16, 1, 6),
                                           ((3, 5, 4), 9, 4, 3),
                                           ((2, 3), 2, 1, 6)])
def test_kernel_matches_plain(cuda, lead, K, n, band):
    pe1, pe2, qs = _column(lead, K, band, seed=11)
    qd = [torch.from_numpy(q).to(cuda) for q in qs[:n]]
    p1, p2 = torch.from_numpy(pe1).to(cuda), torch.from_numpy(pe2).to(cuda)
    before = remap_banded.launches
    got = remap_banded(qd, p1, p2, band=band)
    torch.cuda.synchronize()
    assert remap_banded.launches == before + 1
    want = tremap.remap_fields_banded(qd, p1, p2, band=band)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_kernel_rejects_bad_inputs(cuda):
    pe1, pe2, qs = _column((4,), 8, 6, seed=13)
    q = torch.from_numpy(qs[0]).to(cuda)
    p1, p2 = torch.from_numpy(pe1).to(cuda), torch.from_numpy(pe2).to(cuda)
    with pytest.raises(TypeError):
        remap_banded([q.double()], p1, p2)
    with pytest.raises(ValueError):
        remap_banded([q[:, :7]], p1, p2)
    with pytest.raises(ValueError):
        remap_banded([q.t().contiguous().t()], p1, p2)
    with pytest.raises(ValueError):
        remap_banded([q] * 5, p1, p2)


def test_model_on_card_matches_cpu(cuda):
    """3 steps at c12-L8 from one numpy state, on the card (through the
    kernel: 3 launches per step) and on the CPU (plain version)."""
    cfg = DycoreConfig(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6)
    m_cpu = build_model(cfg, "cpu")
    m_gpu = build_model(cfg, cuda)
    start = state_to_numpy(m_cpu.init(perturb=3.0))
    a = state_to_numpy(m_cpu.run(state_from_numpy(start, "cpu"), 3))
    before = remap_banded.launches
    b = state_to_numpy(m_gpu.run(state_from_numpy(start, cuda), 3))
    assert remap_banded.launches == before + 9
    for f in ("u", "v", "delp", "pt", "ps"):
        scale = float(np.abs(a[f]).max())
        atol = 6e-3 if f in ("u", "v") else 0.0
        assert float(np.abs(a[f] - b[f]).max()) <= max(1e-4 * scale, atol), f


def test_model_rejects_unported_option_on_card(cuda):
    cfg = dataclasses.replace(DycoreConfig(npx=12, npz=8), rim_split=True,
                              overlap_fills=True)
    with pytest.raises(NotImplementedError):
        build_model(cfg, cuda)


# ---- the fused substep kernels -------------------------------------------

SMALL = DycoreConfig(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6)
NH = dataclasses.replace(SMALL, hydrostatic=False, z_tracer=False)
COLUMN_KERNELS = ("dsw_csw2", "dsw_wind", "dsw_nh_pert")   # gate with a floor
# kernel checks: "<kernel>" or "<kernel> <form>"; the form picks the model
# the arguments come from (nh: nonhydrostatic with per-substep tracers,
# blend: the blend damping form)
CASES = ["dsw_csw1", "dsw_csw2", "dsw_transport", "dsw_wind",
         "dsw_tracer_acc", "dsw_transport nh", "dsw_wind nh", "dsw_tracer",
         "dsw_nh_pert", "dsw_wind blend", "dsw_wind nh+blend"]


def _within_gate(name, got, want):
    """Whole padded outputs: 1e-5 of max|plain|, or for the kernels that
    integrate columns max(1e-4 x max|plain|, 2e-3)."""
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32, (name, n)
        assert bool(g.isfinite().all()), (name, n)
        scale = float(w.abs().max())
        limit = (max(1e-4 * scale, 2e-3) if name in COLUMN_KERNELS
                 else 1e-5 * scale)
        assert float((g - w).abs().max()) <= limit, (name, n)


def _model_args(model, dev):
    """Every kernel's arguments in the model's mode, from a real c12-L8
    state on the card: 3 K of pt noise, a tracer, 2 steps, then one
    substep of plain versions (in z_tracer mode the accumulated-flux
    tracer kernel takes that substep's fluxes)."""
    cfg, ctx = model.config, model.ctx
    st = model.init(perturb=3.0)
    rng = np.random.default_rng(5)
    st.q = torch.as_tensor((1.0 + 0.2 * rng.random(tuple(st.q.shape)))
                           .astype(np.float32), device=dev)
    st = model.run(st, 2)
    dt = cfg.dt / cfg.n_split
    nonhydro = not cfg.hydrostatic
    s = fill_substep(ctx.ops, st.u, st.v, st.delp, st.pt,
                     None if cfg.z_tracer else st.q,
                     w=st.w if nonhydro else None,
                     delz=st.delz if nonhydro else None, chart=ctx.chart)
    args, out = substep_kernel_args(
        s, ctx.metrics, ctx.ops, dt, cfg.ptop, hord=cfg.hord,
        d2_bg=cfg.d2_bg, advect_tracers=not cfg.z_tracer,
        hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm, chart=ctx.chart,
        stag_tabs=ctx.stag if _use_exchange(cfg) else None, vtx_damp=0.05)
    if cfg.z_tracer:
        qx = ctx.chart.apply_scalar(ctx.ops.fill(st.q[..., 0], "x"), "x")
        args["dsw_tracer_acc"] = (qx, qx, s.pd_x, out.uct_pad, out.vct_pad,
                                  out.mfx_pad, out.mfy_pad, ctx.metrics, dt,
                                  cfg.hord)
    return args


def _synthetic_args(case, F, Ny, Nx, K, seed, dev):
    """Random, well-conditioned arguments of a kernel check on a face of
    Ny x Nx padded cells (Ny != Nx: every extent is exercised): metrics
    near a unit grid, Courant numbers below 0.5, a blend mask set on about
    half the corners."""
    name, _, form = case.partition(" ")
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.uniform(-1.0, 1.0, shape)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    c, xi, yi = (F, Ny, Nx, K), (F, Ny, Nx + 1, K), (F, Ny + 1, Nx, K)
    cn = (F, Ny + 1, Nx + 1, K)
    small = {"fcor": 1e-4, "cosa_i": 0.1, "cosa_j": 0.1, "cosa_c": 0.1,
             "cosa_cn": 0.1, "dw00": 0.05, "dw01": 0.05, "dw10": 0.05,
             "dw11": 0.05, "jwm": 0.2, "jwp": 0.2, "iwm": 0.2, "iwp": 0.2,
             "dr11": 0.05, "r12": 0.05, "r21": 0.05, "dr22": 0.05}
    mets = {}
    for f, (sy, sx) in METRIC_STAGGER.items():
        shape = (F, Ny + sy, Nx + sx, 1)
        if f == "phis":
            mets[f] = np.zeros(shape)
        elif f == "div_blend":
            mets[f] = (rng.random(shape) < 0.5).astype(np.float32)
        elif f in small:
            mets[f] = small[f] * u(*shape)
        else:
            mets[f] = 1.0 + 0.1 * u(*shape)
    m = PaddedMetrics(**{f: t(a) for f, a in mets.items()})
    delp = lambda shape: 1000.0 + 100.0 * u(*shape)
    pt = lambda shape: 300.0 + 10.0 * u(*shape)
    wind = lambda shape: 0.3 * u(*shape)
    delz = lambda shape: 80.0 + 8.0 * u(*shape)    # ~ delp R T / (g p)
    if name == "dsw_csw1":
        return (t(wind(yi)), t(wind(xi)), t(wind(c)), t(wind(c)),
                t(delp(c)), t(delp(c)), t(pt(c)), t(pt(c)), m, 0.5)
    if name == "dsw_csw2":
        return (t(wind(xi)), t(wind(yi)), t(delp(c)), t(pt(c)),
                t(rng.uniform(0.0, 1.0, c)), t(1e-4 * u(*c)), m, 100.0, 0.5)
    if name == "dsw_transport":
        nh = (t(wind(c)), t(wind(c)), t(delz(c)), t(delz(c))) \
            if form == "nh" else None
        return (t(delp(c)), t(delp(c)), t(pt(c)), t(pt(c)), t(wind(xi)),
                t(wind(yi)), m, 1.0, 8, nh)
    if name == "dsw_wind":
        div_c = None if "blend" in form else t(1e-5 * u(*cn))
        delz_f = t(delz(c)) if "nh" in form else None
        return (t(wind(yi)), t(wind(xi)), t(wind(xi)), t(wind(yi)),
                t(delp(c)), t(pt(c)), t(1e-4 * u(*c)), div_c, m,
                100.0, 1.0, 8, 0.015, 0.05, delz_f)
    if name == "dsw_nh_pert":
        return (t(delp(c)), t(pt(c)), t(delz(c)), 100.0)
    if name == "dsw_tracer":
        return (t(pt(c) / 300.0), t(pt(c) / 300.0), t(delp(c)), t(delp(c)),
                t(wind(xi)), t(wind(yi)), t(100.0 * u(*xi)),
                t(100.0 * u(*yi)), m, 1.0, 8)
    return (t(pt(c) / 300.0), t(pt(c) / 300.0), t(delp(c)), t(wind(xi)),
            t(wind(yi)), t(100.0 * u(*xi)), t(100.0 * u(*yi)), m, 1.0, 8)


@pytest.fixture(scope="module")
def c12_args():
    """{case: args} for every entry of CASES, from three c12-L8 models."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    out = dict(_model_args(build_model(SMALL, dev), dev))
    forms = {"nh": NH,
             "blend": dataclasses.replace(SMALL, damping_exchange="blend"),
             "nh+blend": dataclasses.replace(NH, damping_exchange="blend")}
    for form, cfg in forms.items():
        for k, a in _model_args(build_model(cfg, dev), dev).items():
            out[k if k in ("dsw_tracer", "dsw_nh_pert") else f"{k} {form}"] = a
    return out


@pytest.mark.parametrize("case", CASES)
def test_dsw_kernel_matches_plain_c12(c12_args, case):
    name = case.split()[0]
    a = c12_args[case]
    kern = getattr(dsw, name)
    before = kern.launches
    got = kern(*a)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    _within_gate(name, got, getattr(dsw, name + "_plain")(*a))


@pytest.mark.parametrize("case", CASES)
def test_dsw_kernel_matches_plain_non_square(cuda, case):
    name = case.split()[0]
    a = _synthetic_args(case, 2, 10, 13, 9, seed=3, dev=cuda)
    got = getattr(dsw, name)(*a)
    torch.cuda.synchronize()
    _within_gate(name, got, getattr(dsw, name + "_plain")(*a))


def test_nh_wind_launches_the_column_stage(cuda):
    """The nonhydrostatic dsw_wind runs dsw_nh_pert first, once."""
    a = _synthetic_args("dsw_wind nh", 1, 6, 7, 4, seed=5, dev=cuda)
    before = dsw.dsw_nh_pert.launches, dsw.dsw_wind.launches
    dsw.dsw_wind(*a)
    dsw.dsw_wind(*a[:14])          # hydrostatic: no column stage
    torch.cuda.synchronize()
    assert dsw.dsw_nh_pert.launches == before[0] + 1
    assert dsw.dsw_wind.launches == before[1] + 2


@pytest.mark.parametrize("case", CASES)
def test_dsw_wrapper_rejects_bad_inputs(cuda, case):
    name = case.split()[0]
    a = list(_synthetic_args(case, 1, 6, 7, 4, seed=4, dev=cuda))
    kern = getattr(dsw, name)
    with pytest.raises(TypeError):
        kern(*([a[0].double()] + a[1:]))
    with pytest.raises(ValueError):
        kern(*([a[0][..., :-1].contiguous()] + a[1:]))
    with pytest.raises(ValueError):
        kern(*([a[0].transpose(1, 2).contiguous().transpose(1, 2)] + a[1:]))
    mets = [x for x in a if isinstance(x, PaddedMetrics)]
    if mets:
        bad = mets[0]._replace(area=mets[0].area.double())
        with pytest.raises(TypeError):
            kern(*[bad if x is mets[0] else x for x in a])
    if case == "dsw_transport nh":
        nh = a[9]
        with pytest.raises(ValueError):
            kern(*(a[:9] + [(nh[0], nh[1], nh[2][..., :-1].contiguous(),
                             nh[3])]))
    if case == "dsw_wind nh":
        with pytest.raises(ValueError):
            kern(*(a[:14] + [a[14][:, :-1].contiguous()]))


def _card_vs_cpu(cfg, cuda, fields, per_step):
    """3 steps at c12-L8 from one numpy state on the card and on the CPU;
    per_step: launches per step of dsw.KERNELS + remap_banded."""
    m_cpu = build_model(cfg, "cpu")
    m_gpu = build_model(cfg, cuda)
    start = state_to_numpy(m_cpu.init(perturb=3.0))
    rng = np.random.default_rng(5)
    start["q"] = (1.0 + 0.2 * rng.random(start["q"].shape)).astype(np.float32)
    a = state_to_numpy(m_cpu.run(state_from_numpy(start, "cpu"), 3))
    kernels = list(dsw.KERNELS) + [remap_banded]
    before = [k.launches for k in kernels]
    b = state_to_numpy(m_gpu.run(state_from_numpy(start, cuda), 3))
    assert [k.launches - b0 for k, b0 in zip(kernels, before)] \
        == [3 * n for n in per_step]
    for f in fields:
        scale = float(np.abs(a[f]).max())
        atol = 6e-3 if f in ("u", "v", "w") else 0.0
        assert float(np.abs(a[f] - b[f]).max()) <= max(1e-4 * scale, atol), f


def test_fused_model_on_card_matches_cpu(cuda):
    """3 fused steps at c12-L8, on the card (through the five kernels of
    the hydrostatic z_tracer path) and on the CPU (their plain versions)."""
    cfg = dataclasses.replace(SMALL, ntracers=1, pallas_dycore=True)
    n = cfg.n_split
    _card_vs_cpu(cfg, cuda, ("u", "v", "delp", "pt", "q", "ps"),
                 [n, n, n, n, cfg.q_split, 0, 0, 3])


def test_nh_fused_model_on_card_matches_cpu(cuda):
    """The nonhydrostatic model with per-substep tracers: NH dsw_transport,
    dsw_tracer, dsw_nh_pert and NH dsw_wind once per substep, no
    dsw_tracer_acc."""
    cfg = dataclasses.replace(NH, ntracers=1, pallas_dycore=True,
                              w_sponge_p=2.0e4)
    n = cfg.n_split
    _card_vs_cpu(cfg, cuda, ("u", "v", "delp", "pt", "q", "ps", "w", "delz"),
                 [n, n, n, n, 0, n, n, 3])


def test_blend_fused_model_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(SMALL, ntracers=1, pallas_dycore=True,
                              damping_exchange="blend")
    n = cfg.n_split
    _card_vs_cpu(cfg, cuda, ("u", "v", "delp", "pt", "q", "ps"),
                 [n, n, n, n, cfg.q_split, 0, 0, 3])

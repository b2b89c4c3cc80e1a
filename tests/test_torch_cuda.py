"""Tests that need an NVIDIA card: the CUDA kernels (remap_banded, the
fused substep kernels in every form - hydrostatic, nonhydrostatic, blend -
and the nonhydrostatic vertical solve, and the seven column-physics
kernels, gfdl_microphysics and fill_q2_zero in every element at the edges
of their tiles of columns, fill_q2_zero in its multi-tracer form too,
cup_gf_sh and aer_activation in every element across their blocks' runs
of points and on inputs off a 16-byte boundary)
the two chart-corner kernels (chart_scalar, chart_agrid: in place, at
the c48-L72 and c192-L72 shapes and on the gated slots of the (2,4) step)
and the A-grid winds (agrid_winds: bit for bit, signed zeros included, at
the shapes of every path that runs it, and three fused steps of each
model with it and with its plain version patched in) against their plain
PyTorch versions, their input checks, the physics gate
on the card, the hardware sampler's NVML readings of the card (the handle
is torch's device, the energy counter never decreases, the utilization
rises under load and falls back when idle), and the port's models on the
card against the CPU:
Held-Suarez eager, fused, nonhydrostatic with per-substep tracers and the
blend damping form, the fused aquaplanet model and the fused JW06 model
with its terrain.  The synthetic kernel inputs carry a smooth terrain that
varies by face, row and column, so that dsw_csw2 and dsw_wind add it at
every column's own index.  They skip without CUDA.
This file imports no jax, so on the card's machine it runs on its own:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q
"""
import dataclasses
import time

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
          for _ in range(6)]
    return pe1.astype(np.float32), pe2.astype(np.float32), qs


# remap_banded takes a tile of up to 16 columns a block: column counts that
# are no multiple of it, the D-grid wind shapes of c48-L72 at K = 72 and
# band 6, and every field count (5 and 6 take two launches)
REMAP_LEADS = [(6, 49, 48), (6, 48, 49), (37,), (1,), (33,), (5, 7)]
REMAP_CASES = [((6, 7, 5), 16, 2, 6), ((6, 6, 7), 16, 1, 6),
               ((3, 5, 4), 9, 4, 3), ((2, 3), 2, 1, 6), ((6, 7, 5), 16, 6, 6)
               ] + [(lead, 72, n, 6) for lead in REMAP_LEADS
                    for n in range(1, 7)]


@pytest.mark.parametrize("lead,K,n,band", REMAP_CASES)
def test_kernel_matches_plain(cuda, lead, K, n, band):
    """Up to MAX_FIELDS fields a launch; six take two.  Equal to the plain
    version in every element."""
    pe1, pe2, qs = _column(lead, K, band, seed=11)
    qd = [torch.from_numpy(q).to(cuda) for q in qs[:n]]
    p1, p2 = torch.from_numpy(pe1).to(cuda), torch.from_numpy(pe2).to(cuda)
    before = remap_banded.launches
    got = remap_banded(qd, p1, p2, band=band)
    torch.cuda.synchronize()
    assert len(got) == n
    assert remap_banded.launches == before + (1 if n <= 4 else 2)
    want = tremap.remap_fields_banded(qd, p1, p2, band=band)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float((g - w).abs().max()) == 0.0


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
        remap_banded([], p1, p2)


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


def test_rim_split_step_equals_unsplit_on_card(cuda):
    """overlap_fills with and without rim_split, 2 steps at c12-L8 on the
    card: the flag is accepted and gives the unsplit step (the port's rank
    groups exchange synchronously, so the split would not pay)."""
    cfg = dataclasses.replace(DycoreConfig(npx=12, npz=8, dt=1200.0,
                                           n_split=2), overlap_fills=True)
    split = build_model(dataclasses.replace(cfg, rim_split=True), cuda)
    unsplit = build_model(cfg, cuda)
    start = split.init(perturb=3.0)
    a, b = split.run(start, 2), unsplit.run(start, 2)
    for f in ("u", "v", "delp", "pt", "ps"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- the fused substep kernels -------------------------------------------

SMALL = DycoreConfig(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6)
NH = dataclasses.replace(SMALL, hydrostatic=False, z_tracer=False)
COLUMN_KERNELS = ("dsw_csw2", "dsw_wind", "dsw_nh_pert")   # gate with a floor
# kernel checks: "<kernel>" or "<kernel> <form>"; the form picks the model
# the arguments come from (nh: nonhydrostatic with per-substep tracers,
# blend: the blend damping form)
CASES = ["dsw_csw1", "dsw_csw2", "dsw_transport", "dsw_wind",
         "dsw_tracer_acc", "dsw_transport nh", "dsw_wind nh", "dsw_tracer",
         "dsw_nh_pert", "dsw_wind blend", "dsw_wind nh+blend",
         "nh_vertical_solve nh", "agrid_winds"]


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
    if cfg.z_tracer and cfg.ntracers:
        qx = ctx.chart.apply_scalar(ctx.ops.fill(st.q[..., 0], "x"), "x")
        args["dsw_tracer_acc"] = (qx, qx, s.pd_x, out.uct_pad, out.vct_pad,
                                  out.mfx_pad, out.mfy_pad, ctx.metrics, dt,
                                  cfg.hord)
    return args


def _blend_mask(mask, F, Ny, Nx):
    """div_blend [F, Ny+1, Nx+1, 1] of a BLEND_MASKS entry other than
    "random": every corner in the cell form ("cell"), none ("dual"), or
    the corners less than w from a face edge ("band<w>"), as
    padded_metrics marks the band along the edges."""
    if mask == "cell":
        return np.ones((F, Ny + 1, Nx + 1, 1), np.float32)
    if mask == "dual":
        return np.zeros((F, Ny + 1, Nx + 1, 1), np.float32)
    w = int(mask.removeprefix("band"))
    j = np.arange(Ny + 1)[:, None]
    i = np.arange(Nx + 1)[None, :]
    d = np.minimum(np.minimum(j, i), np.minimum(Ny - j, Nx - i))
    return np.broadcast_to((d < w).astype(np.float32)[None, ..., None],
                           (F, Ny + 1, Nx + 1, 1)).copy()


def _synthetic_args(case, F, Ny, Nx, K, seed, dev, mask="random"):
    """Random, well-conditioned arguments of a kernel check on a face of
    Ny x Nx padded cells (Ny != Nx: every extent is exercised): metrics
    near a unit grid, Courant numbers below 0.5, a blend mask set on about
    half the corners (or the mask `mask`, _blend_mask), and a smooth
    terrain phis of ~2e4 m2/s2 that differs along faces, rows and columns
    (a transposed or shifted index of the column stages shows)."""
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
            ff, jj, ii = np.meshgrid(np.arange(F), np.arange(Ny),
                                     np.arange(Nx), indexing="ij")
            mets[f] = (2e4 * (0.5 + np.sin(0.4 * jj + 1.1 * ff)
                              * np.cos(0.3 * ii - 0.7 * ff) + 0.05 * ii)
                       )[..., None]
        elif f == "div_blend":
            mets[f] = (rng.random(shape) < 0.5).astype(np.float32)
            if mask != "random":
                mets[f] = _blend_mask(mask, F, Ny, Nx)
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
    if name == "agrid_winds":
        return (t(wind(yi)), t(wind(xi)), m)
    if name == "nh_vertical_solve":
        # far from balance at depth: the solve's delz reaches the 1 m clamp
        # in some columns from K = 17 on
        return (t(wind(c)), t(delz(c)), t(pt(c)), t(delp(c)), 100.0, 100.0)
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


# dsw_csw1, dsw_csw2, dsw_wind, dsw_nh_pert and the fvtp2d stage of
# dsw_transport, dsw_tracer and dsw_tracer_acc work on tiles: 32 columns per
# block in the column stages, 8 x 8 points x 8 levels in the horizontal
# stages, with a rim of up to 3 cells.  Faces whose column count, Ny + 1,
# Nx + 1 and K are no multiples of the tiles, and one whose corners fill the
# tiles exactly; K below, at and above a chunk, odd, and the presets' 32
# and 72.
TILE_FACES = [(2, 10, 13), (1, 15, 7), (1, 4, 5)]
TILE_CASES = ["dsw_csw2", "dsw_wind", "dsw_wind blend", "dsw_wind nh",
              "dsw_wind nh+blend", "dsw_csw1", "dsw_transport",
              "dsw_transport nh", "dsw_tracer_acc", "dsw_tracer",
              "dsw_nh_pert", "nh_vertical_solve", "agrid_winds"]


def _equal_to_plain(case, a):
    """One launch of the wrapper, equal to its plain version in every
    element."""
    name = case.split()[0]
    kern = getattr(dsw, name)
    before = kern.launches
    got = kern(*a)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = getattr(dsw, name + "_plain")(*a)
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and bool(g.isfinite().all()), (case, n)
        assert float((g - w).abs().max()) == 0.0, (case, n)


@pytest.mark.parametrize("K", [8, 32, 33, 72])
@pytest.mark.parametrize("face", TILE_FACES,
                         ids=["x".join(map(str, f)) for f in TILE_FACES])
@pytest.mark.parametrize("case", TILE_CASES)
def test_dsw_tile_edges_match_plain(cuda, case, face, K):
    """The tiled kernels equal their plain versions in every element, also
    at the ragged edges of the tiles."""
    _equal_to_plain(case, _synthetic_args(case, *face, K, seed=7, dev=cuda))


# The blend form of dsw_wind forms each corner's damping divergence in its
# tile: the dual contour of pu/pv or, where div_blend is set, the
# interpolated cell divergence of uct/vct, the latter behind a barrier that
# only blocks with a cell corner take.  Every corner in one form, and bands
# along the face edges 2 to 10 corners wide, whose inner borders cross the
# 8 x 8 tile edges; on a face whose last row and column of tiles hold only
# the corners Ny and Nx (16 x 24), and on one whose tiles are ragged.
BLEND_MASKS = ["cell", "dual", "band2", "band3", "band5", "band10"]
BLEND_FACES = [(1, 16, 24), (2, 27, 20)]


@pytest.mark.parametrize("K", [8, 33, 72])
@pytest.mark.parametrize("face", BLEND_FACES,
                         ids=["x".join(map(str, f)) for f in BLEND_FACES])
@pytest.mark.parametrize("mask", BLEND_MASKS)
@pytest.mark.parametrize("case", ["dsw_wind blend", "dsw_wind nh+blend"])
def test_dsw_wind_blend_masks_match_plain(cuda, case, mask, face, K):
    _equal_to_plain(case, _synthetic_args(case, *face, K, seed=13, dev=cuda,
                                          mask=mask))


# The column stages (hydro_columns of dsw_csw2 and dsw_wind, nh_columns of
# dsw_nh_pert, nh_vertical_columns of nh_vertical_solve) also at K of a few
# levels (K = 2: one unknown of the tridiagonal), odd, and where the tile
# shrinks below 32 columns (nh_columns above K = 76, hydro_columns above
# K = 127), on the ragged faces of TILE_FACES.  nh_vertical_columns spreads
# a call's columns over the fewest waves of two blocks an SM: on these
# faces one column a block; at the NH preset's 17,496 columns its tile of
# 67 no longer fits two blocks an SM from K = 87 on (4 (K - 1 | 1) + (K | 1)
# floats a column), and it halves to 34 in two waves
# (test_nh_vertical_solve_tile_shrinks).
@pytest.mark.parametrize("K", [2, 17, 77, 87, 88, 129])
@pytest.mark.parametrize("face", TILE_FACES,
                         ids=["x".join(map(str, f)) for f in TILE_FACES])
@pytest.mark.parametrize("case", ["dsw_nh_pert", "dsw_csw2", "dsw_wind",
                                  "dsw_wind nh", "nh_vertical_solve"])
def test_column_stages_match_plain(cuda, case, face, K):
    _equal_to_plain(case, _synthetic_args(case, *face, K, seed=11, dev=cuda))


# nh_vertical_columns' tile on the NH preset's padded columns (6 faces of
# 54 x 54): 67 columns a block in one wave up to K = 86, 34 in two waves
# from K = 87; and deep columns, where two blocks an SM hold one column up
# to K = 5786 and one block takes over
@pytest.mark.parametrize("K", [72, 86, 87, 88])
def test_nh_vertical_solve_tile_shrinks(cuda, K):
    _equal_to_plain("nh_vertical_solve", _synthetic_args(
        "nh_vertical_solve", 6, 54, 54, K, seed=17, dev=cuda))


@pytest.mark.parametrize("K", [5786, 5787])
def test_nh_vertical_solve_deep_columns(cuda, K):
    _equal_to_plain("nh_vertical_solve", _synthetic_args(
        "nh_vertical_solve", 1, 4, 5, K, seed=19, dev=cuda))


def test_nh_vertical_solve_repeated_calls(cuda):
    """The launch reads the device's limits and opts the kernel in once per
    device: two calls on the same inputs and one on fresh inputs of
    another K each equal the plain version."""
    a = _synthetic_args("nh_vertical_solve", 2, 10, 13, 72, seed=21,
                        dev=cuda)
    _equal_to_plain("nh_vertical_solve", a)
    _equal_to_plain("nh_vertical_solve", a)
    _equal_to_plain("nh_vertical_solve", _synthetic_args(
        "nh_vertical_solve", 1, 15, 7, 33, seed=23, dev=cuda))


# The forward sweep's divisions (csrc/nh_vertical_columns.cuh:
# refined_reciprocal, quotient) against __fdiv_rn on random operands whose
# magnitudes lie in [2^-60, 2^61): random mantissas, every mantissa of the
# denominator in turn, and mantissas near 1 and 2.
SPLIT_DIVISION_CU = r"""
#include <cstdint>
#include "nh_vertical_columns.cuh"

__device__ uint64_t mix(uint64_t x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL; x ^= x >> 33;
  return x;
}

__device__ float operand(uint64_t h, uint32_t i, int mode) {
  uint32_t mant = (uint32_t)h & 0x7fffffu;
  if (mode == 1) mant = i & 0x7fffffu;
  if (mode == 2)
    mant = (h & 1) ? 0x7fffffu - (uint32_t)(h >> 1 & 0xff)
                   : (uint32_t)(h >> 1 & 0xff);
  const uint32_t e = 127 - 60 + (uint32_t)((h >> 24) % 121);
  return __uint_as_float(((uint32_t)(h >> 40) & 1u) << 31 | e << 23 | mant);
}

__global__ void check(unsigned long long base, int mode,
                      unsigned long long* bad) {
  const unsigned long long i =
      base + blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  const float n = operand(mix(2 * i + 1), (uint32_t)i, mode == 2 ? 2 : 0);
  const float d = operand(mix(2 * i + 2 + ((uint64_t)mode << 40)),
                          (uint32_t)i, mode);
  const float r = nhv::refined_reciprocal(d);
  if (__float_as_uint(nhv::quotient(n, d, r)) !=
          __float_as_uint(__fdiv_rn(n, d)) ||
      __float_as_uint(nhv::quotient(1.0f, d, r)) !=
          __float_as_uint(__fdiv_rn(1.0f, d)))
    atomicAdd(bad, 1ULL);
}

extern "C" long long split_division_mismatches(int mode, int launches) {
  unsigned long long* bad = nullptr;
  if (cudaMallocManaged(&bad, sizeof(*bad)) != cudaSuccess) return -1;
  *bad = 0;
  const unsigned long long per = 1ULL << 28;
  for (int k = 0; k < launches; ++k)
    check<<<(unsigned)(per / 256), 256>>>(k * per, mode, bad);
  const cudaError_t err = cudaDeviceSynchronize();
  const long long out = err == cudaSuccess ? (long long)*bad : -1;
  cudaFree(bad);
  return out;
}
"""


def test_split_division_equals_ieee_division(cuda, tmp_path):
    import ctypes
    import subprocess

    from geosongpu_tpu_torch.ops.kernels import build

    src = tmp_path / "split_division.cu"
    src.write_text(SPLIT_DIVISION_CU)
    so = tmp_path / "libsplit_division.so"
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-shared",
                    "-I", str(build.CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).split_division_mismatches
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    for mode in (0, 1, 2):       # 2^34 pairs each (mode 1: 2^11 per mantissa)
        assert fn(mode, 64) == 0, mode


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["dsw_transport nh", "dsw_tracer_acc"])
def test_fvtp2d_tile_short_columns(cuda, case, K):
    """The fvtp2d stage (two fields and one) with fewer levels than a chunk:
    the idle level lanes fetch the last level and write nothing."""
    _equal_to_plain(case, _synthetic_args(case, 1, 15, 7, K, seed=9,
                                          dev=cuda))


@pytest.mark.parametrize("form", ["nh", "nh+blend"])
def test_nh_vertical_solve_equals_plain_c12(c12_args, form):
    """The vertical solve on the c12-L8 nonhydrostatic model's own inputs
    (the padded transport outputs after 2 steps): 0.0 from its plain
    version over every column."""
    _equal_to_plain("nh_vertical_solve", c12_args[f"nh_vertical_solve {form}"])


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


def _card_vs_cpu(cfg, cuda, fields, per_step, build=build_model,
                 noise_floor=False):
    """3 steps at c12-L8 from one numpy state on the card and on the CPU;
    per_step: launches per step of dsw.KERNELS + remap_banded; build: the
    model's build_model.  noise_floor: each field's gate also admits twice
    the CPU's own spread, the 3 steps from the start state with pt one ulp
    up in a seeded half of the cells."""
    m_cpu = build(cfg, "cpu")
    m_gpu = build(cfg, cuda)
    start = state_to_numpy(m_cpu.init(perturb=3.0))
    rng = np.random.default_rng(5)
    start["q"] = (1.0 + 0.2 * rng.random(start["q"].shape)).astype(np.float32)
    a = state_to_numpy(m_cpu.run(state_from_numpy(start, "cpu"), 3))
    kernels = list(dsw.KERNELS) + [remap_banded]
    before = [k.launches for k in kernels]
    b = state_to_numpy(m_gpu.run(state_from_numpy(start, cuda), 3))
    assert [k.launches - b0 for k, b0 in zip(kernels, before)] \
        == [3 * n for n in per_step]
    floor = dict.fromkeys(fields, 0.0)
    if noise_floor:
        pt = start["pt"].copy()
        up = np.random.default_rng(0).random(pt.shape) < 0.5
        pt[up] = np.nextafter(pt[up], np.float32(np.inf))
        c = state_to_numpy(m_cpu.run(state_from_numpy({**start, "pt": pt},
                                                      "cpu"), 3))
        floor = {f: 2.0 * float(np.abs(a[f] - c[f]).max()) for f in fields}
    for f in fields:
        scale = float(np.abs(a[f]).max())
        atol = 6e-3 if f in ("u", "v", "w") else 0.0
        assert float(np.abs(a[f] - b[f]).max()) \
            <= max(1e-4 * scale, atol, floor[f]), f


def test_fused_model_on_card_matches_cpu(cuda):
    """3 fused steps at c12-L8, on the card (through the five kernels of
    the hydrostatic z_tracer path) and on the CPU (their plain versions)."""
    cfg = dataclasses.replace(SMALL, ntracers=1, pallas_dycore=True)
    n = cfg.n_split
    _card_vs_cpu(cfg, cuda, ("u", "v", "delp", "pt", "q", "ps"),
                 [n, n, n, n, cfg.q_split, 0, 0, 0, n, 3])


def test_nh_fused_model_on_card_matches_cpu(cuda):
    """The nonhydrostatic model with per-substep tracers: NH dsw_transport,
    dsw_tracer, dsw_nh_pert, nh_vertical_solve and NH dsw_wind once per
    substep, no dsw_tracer_acc."""
    cfg = dataclasses.replace(NH, ntracers=1, pallas_dycore=True,
                              w_sponge_p=2.0e4)
    n = cfg.n_split
    _card_vs_cpu(cfg, cuda, ("u", "v", "delp", "pt", "q", "ps", "w", "delz"),
                 [n, n, n, n, 0, n, n, n, n, 3])


@pytest.mark.parametrize("form", ["hydrostatic", "nonhydrostatic",
                                  "aquaplanet"])
def test_kernel_spans_count_the_launches(cuda, form):
    """Recorded on the card, each fused step holds one `kernel.<name>`
    span per launch each wrapper's `launches` counter counts (dsw_nh_pert
    inside dsw_wind, fill_q2_zero_tracers as fill_q2_zero), and the
    recording leaves the state bit-identical."""
    import collections

    from geosongpu_tpu_torch import spans
    from geosongpu_tpu_torch.models import aquaplanet
    from geosongpu_tpu_torch.ops.kernels import launch_counts

    build = build_model
    cfg = dataclasses.replace(SMALL, ntracers=1, pallas_dycore=True)
    if form == "nonhydrostatic":
        cfg = dataclasses.replace(NH, ntracers=1, pallas_dycore=True)
    elif form == "aquaplanet":
        cfg = dataclasses.replace(SMALL, ntracers=3, pallas_dycore=True,
                                  pallas_microphysics=True)
        build = aquaplanet.build_model
    model = build(cfg, cuda)
    state = model.step(model.init(perturb=3.0))
    ref = model.step(state)
    before = launch_counts()
    with spans.recording() as records:
        got = model.step(state)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in launch_counts().items()
                if n != before[k]}
    counted = collections.Counter(r.name[len("kernel."):] for r in records
                                  if r.name.startswith("kernel."))
    assert launched and dict(counted) == launched
    # each chart-corner call is one launch of its kernel
    calls = collections.Counter(r.name for r in records
                                if r.name.startswith("chart."))
    assert launched["chart_scalar"] == calls["chart.scalar"] > 0
    assert launched["chart_agrid"] == calls["chart.agrid"] > 0
    # the A-grid kernel once a substep, inside the `agrid` span
    assert launched["agrid_winds"] == counted["agrid_winds"] == cfg.n_split
    for r in records:
        if r.name == "kernel.agrid_winds":
            assert records[r.parent].name == "agrid"
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name


def test_aquaplanet_column_kernels_once_a_step(cuda):
    """Two aquaplanet steps recorded on the card: each of the chain's
    column kernels (fill_q2_zero of the three tracers, cup_gf_sh,
    gfdl_microphysics) launches once a step, its `launches` counter equal
    to its `kernel.*` spans, and each `physics` span holds one
    `surface_fluxes` and one `relaxation` span."""
    import collections

    from geosongpu_tpu_torch import spans
    from geosongpu_tpu_torch.models import aquaplanet
    from geosongpu_tpu_torch.ops.kernels import launch_counts

    cfg = dataclasses.replace(SMALL, ntracers=3, pallas_dycore=True,
                              pallas_microphysics=True)
    model = aquaplanet.build_model(cfg, cuda)
    state = model.step(model.init(perturb=3.0))
    before = launch_counts()
    with spans.recording() as records:
        model.run(state, 2)
    torch.cuda.synchronize()
    column = ("fill_q2_zero", "cup_gf_sh", "gfdl_microphysics")
    counted = collections.Counter(r.name for r in records)
    for k in column:
        assert launch_counts()[k] - before[k] == 2 == counted["kernel." + k]
    assert counted["physics"] == counted["surface_fluxes"] \
        == counted["relaxation"] == 2
    inside = {"surface_fluxes", "relaxation"} | {"kernel." + k
                                                   for k in column}
    for r in records:
        if r.name in inside:
            assert records[r.parent].name == "physics", r.name


# agrid_winds (csrc/dsw_agrid.cu) bit for bit at the padded shapes of every
# path that runs it: the c192-L72 and C180-L72 faces of the three cells,
# c48-L72, the aquaplanet's c48-L32, JW06's c48-L26 (K % 4 != 0: one float
# a thread), the stacked (2,4) blocks of c48-L72 (48 slots of 24 x 12) and
# of the c16 sharded experiment (48 of 8 x 4), and a ragged small face
AGRID_SHAPES = {"c192-L72": (6, 198, 198, 72), "C180-L72": (6, 186, 186, 72),
                "c48-L72": (6, 54, 54, 72), "c48-L32": (6, 54, 54, 32),
                "c48-L26": (6, 54, 54, 26),
                "c48-L72 (2,4)": (48, 30, 18, 72),
                "c16-L72 (2,4)": (48, 14, 10, 72), "ragged": (2, 5, 7, 3)}


def _agrid_args(F, Ny, Nx, K, seed, dev):
    """(pu, pv, metrics) on the card: winds of ~30 m/s with a twentieth of
    them -0.0 and a twentieth +0.0, metrics whose rotation and resample
    weights are exact zeros on half the cells (as the interior's are)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = lambda shape: 2.0 * torch.rand(shape, generator=gen,
                                       device=dev) - 1.0

    def wind(shape):
        x, r = 30.0 * u(shape), u(shape)
        x = torch.where(r < -0.9, torch.full_like(x, -0.0), x)
        return torch.where(r > 0.9, torch.zeros_like(x), x)

    mets = {}
    for f, (sy, sx) in METRIC_STAGGER.items():
        shape = (F, Ny + sy, Nx + sx, 1)
        x = 0.2 * u(shape)
        mets[f] = torch.where(u(shape) < 0.0, torch.zeros_like(x), x)
    return (wind((F, Ny + 1, Nx, K)), wind((F, Ny, Nx + 1, K)),
            PaddedMetrics(**mets))


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("shape", list(AGRID_SHAPES))
def test_agrid_winds_bitwise_at_path_shapes(cuda, shape):
    a = _agrid_args(*AGRID_SHAPES[shape], seed=19, dev=cuda)
    before = dsw.agrid_winds.launches
    got = dsw.agrid_winds(*a)
    torch.cuda.synchronize()
    assert dsw.agrid_winds.launches == before + 1
    want = dsw.agrid_winds_plain(*a)
    for g, w in zip(got, want):
        assert _bitwise(g, w), shape


@pytest.mark.parametrize("which", [0, 1], ids=["pu", "pv"])
def test_agrid_winds_unaligned_inputs(cuda, which):
    """An input 4 bytes off a 16-byte boundary takes the one-float form."""
    a = list(_agrid_args(2, 11, 10, 8, seed=23, dev=cuda))
    x = a[which]
    buf = torch.empty(x.numel() + 1, device=cuda)
    buf[1:] = x.reshape(-1)
    a[which] = buf[1:].view(x.shape)
    assert a[which].data_ptr() % 16 != 0 and a[which].is_contiguous()
    for g, w in zip(dsw.agrid_winds(*a), dsw.agrid_winds_plain(*a)):
        assert _bitwise(g, w)


@pytest.mark.parametrize("form", ["hydrostatic", "nonhydrostatic", "blend",
                                  "aquaplanet"])
def test_fused_steps_equal_with_plain_agrid(cuda, form, monkeypatch):
    """3 fused c12-L8 steps on the card through agrid_winds, and again with
    its plain version patched in: every field bit for bit."""
    from geosongpu_tpu_torch.models import aquaplanet

    build = build_model
    cfg = dataclasses.replace(SMALL, ntracers=1, pallas_dycore=True)
    if form == "nonhydrostatic":
        cfg = dataclasses.replace(NH, ntracers=1, pallas_dycore=True)
    elif form == "blend":
        cfg = dataclasses.replace(cfg, damping_exchange="blend")
    elif form == "aquaplanet":
        cfg = dataclasses.replace(SMALL, ntracers=3, pallas_dycore=True,
                                  pallas_microphysics=True)
        build = aquaplanet.build_model
    model = build(cfg, cuda)
    start = model.init(perturb=3.0)
    before = dsw.agrid_winds.launches
    got = model.run(start, 3)
    torch.cuda.synchronize()
    assert dsw.agrid_winds.launches - before == 3 * cfg.n_split
    monkeypatch.setattr(dsw, "agrid_winds", dsw.agrid_winds_plain)
    want = model.run(start, 3)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor) and w.dtype == torch.float32:
            assert _bitwise(g, w), f.name
        elif isinstance(w, torch.Tensor):
            assert torch.equal(g, w), f.name
    assert float((got.u - start.u).abs().max()) > 0.0


# chart corners (csrc/chart_corners.cu): c48-L72, c192-L72 and the gated
# slots of the c48 (2,4) stacked step (48 slots of 24 x 12 cells)
CHART_CASES = ["c48", "c192", "c48 (2,4)"]
CHART_FORMS = ["x", "y", "derived", "agrid"]


@pytest.fixture(scope="module")
def chart_tables():
    from geosongpu_tpu_torch.core.chart_corners import build_chart_tables

    return {}, build_chart_tables


def _chart_case(chart_tables, case, dev):
    """(ChartCorners on dev, F, Ny, Nx) of a case, halo 3."""
    from geosongpu_tpu_torch.core.chart_corners import (
        ChartCorners, sharded_chart_for_subtile)
    from geosongpu_tpu_torch.parallel.subtile import SubtileLayout

    cache, build = chart_tables
    n = 192 if case == "c192" else 48
    if n not in cache:
        cache[n] = build(n, 3)
    chart = ChartCorners.from_tables(cache[n], dev)
    if case.endswith("(2,4)"):
        lay = SubtileLayout(n=n, h=3, py=2, px=4, face_sharded=False)
        chart = sharded_chart_for_subtile(chart, lay, range(lay.ndevices))
        return chart, chart.sc_dw_x.shape[0], n // 2 + 6, n // 4 + 6
    return chart, 6, n + 6, n + 6


def _squares(F, Ny, Nx, W, dev):
    """bool [F, Ny, Nx, 1]: the four W x W corner squares."""
    m = torch.zeros((F, Ny, Nx, 1), dtype=torch.bool, device=dev)
    for ys in (slice(0, W), slice(Ny - W, Ny)):
        for xs in (slice(0, W), slice(Nx - W, Nx)):
            m[:, ys, xs] = True
    return m


@pytest.mark.parametrize("form", CHART_FORMS)
@pytest.mark.parametrize("case", CHART_CASES)
def test_chart_kernels_equal_plain(cuda, chart_tables, case, form):
    """Each call of apply_scalar / apply_agrid on CUDA float32 arrays is
    one launch that patches the caller's arrays in place: 0.0 from the
    plain version; on the six faces 0.0 from the einsum form on the card
    too (the kernels sum in the order of its cuBLAS products there, which
    the benchmark's plain reference runs), on the (2,4) slots within
    float32 rounding of it; every slot outside the corner squares (outside
    the masked targets for the A-grid winds) bit for bit as it was."""
    from geosongpu_tpu_torch.ops.kernels import chart as kchart

    chart, F, Ny, Nx = _chart_case(chart_tables, case, cuda)
    h, K = chart.h, 72
    rng = np.random.default_rng(sum(map(ord, case + form)))

    def rand(*shape, offset=0.0):
        return torch.from_numpy(
            offset + rng.standard_normal(shape).astype(np.float32)).to(cuda)

    if form == "agrid":
        ua, va = rand(F, Ny, Nx, K), rand(F, Ny, Nx, K)
        pu, pv = rand(F, Ny + 1, Nx, K), rand(F, Ny, Nx + 1, K)
        before = [ua.clone(), va.clone()]
        want = kchart.chart_agrid_plain(ua, va, pu, pv, chart.st_w,
                                        chart.st_mask, h)
        einsum = chart._agrid_einsum(ua.clone(), va.clone(), pu, pv)
        n0 = kchart.chart_agrid.launches
        got = chart.apply_agrid(ua, va, pu, pv)
        assert got[0] is ua and got[1] is va
        assert kchart.chart_agrid.launches == n0 + 1
        # the masked target slots of each corner's W x W square
        W = h + 2
        keep = ~_squares(F, Ny, Nx, W, cuda)
        for c, (ys, xs) in enumerate([(slice(0, W), slice(0, W)),
                                      (slice(0, W), slice(Nx - W, Nx)),
                                      (slice(Ny - W, Ny), slice(0, W)),
                                      (slice(Ny - W, Ny), slice(Nx - W, Nx))]):
            m = chart.st_mask[:, c].reshape(-1, W, W, 1)
            keep[:, ys, xs] = ~m.expand(F, W, W, 1)
    else:
        a = rand(F, Ny, Nx, K, offset=300.0)
        before = [a.clone()]
        table = {"x": chart.sc_dw_x, "y": chart.sc_dw_y,
                 "derived": chart.sc_ex}[form]
        want = (kchart.chart_scalar_plain(a, table, h),)
        einsum = (chart._scalar_einsum(a.clone(), table),)
        n0 = kchart.chart_scalar.launches
        got = (chart.apply_scalar(a, form),)
        assert got[0] is a
        assert kchart.chart_scalar.launches == n0 + 1
        keep = ~_squares(F, Ny, Nx, chart.h + 2, cuda)
    torch.cuda.synchronize()
    for g, w, e, b in zip(got, want, einsum, before):
        assert torch.equal(g, w)
        gap = float((g - e).abs().max() / e.abs().max())
        print(f"chart {case} {form}: kernel against the einsum form "
              f"{gap:.3e} of max|x|")
        # 0.0: the kernels sum in the order of the einsum's cuBLAS products,
        # as fitted on torch 2.11.0+cu128 with cuBLAS 12.9.2
        # (csrc/chart_corners.cu); another version may order them otherwise
        assert gap == 0.0 if F == 6 else gap <= 1e-5
        k = keep.expand_as(g)
        assert torch.equal(g[k], b[k])
        assert not torch.equal(g, b)


def test_chart_wrappers_reject_bad_inputs(cuda, chart_tables):
    from geosongpu_tpu_torch.ops.kernels import chart as kchart

    chart, F, Ny, Nx = _chart_case(chart_tables, "c48", cuda)
    a = torch.zeros((F, Ny, Nx, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kchart.chart_scalar(a.transpose(1, 2), chart.sc_dw_x, 3)
    with pytest.raises(ValueError, match="too few"):
        kchart.chart_scalar(a[:, :9], chart.sc_dw_x, 3)
    with pytest.raises(ValueError, match="weights"):
        kchart.chart_scalar(a[:5].contiguous(), chart.sc_dw_x, 3)
    with pytest.raises(ValueError, match="mask"):
        kchart.chart_agrid(a, a.clone(), torch.zeros((F, Ny + 1, Nx, 8),
                                                      device=cuda),
                           torch.zeros((F, Ny, Nx + 1, 8), device=cuda),
                           chart.st_w, chart.st_mask.float(), 3)


def test_blend_fused_model_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(SMALL, ntracers=1, pallas_dycore=True,
                              damping_exchange="blend")
    n = cfg.n_split
    _card_vs_cpu(cfg, cuda, ("u", "v", "delp", "pt", "q", "ps"),
                 [n, n, n, n, cfg.q_split, 0, 0, 0, n, 3])


def test_jw_fused_model_on_card_matches_cpu(cuda):
    """The JW06 model at c12-L26 with its terrain, perturbed: the four
    substep kernels and remap_banded (pt alone: no tracers), on the card
    and on the CPU.  The trajectory's own float32 noise exceeds the wind
    floor there (one ulp of pt moves u by 5.4e-3 m/s in 3 steps on the
    CPU), so the gate also admits twice that spread."""
    from geosongpu_tpu_torch.models import baroclinic_wave

    cfg = DycoreConfig(npx=12, npz=26, dt=1200.0, n_split=2, ntracers=0,
                       pallas_dycore=True)
    n = cfg.n_split
    _card_vs_cpu(cfg, cuda, ("u", "v", "delp", "pt", "ps"),
                 [n, n, n, n, 0, 0, 0, 0, n, 3],
                 build=baroclinic_wave.build_model, noise_floor=True)


@pytest.mark.parametrize("name", ["dsw_csw2", "dsw_wind"])
def test_terrain_kernels_equal_plain_on_jw_state(cuda, name):
    """dsw_csw2 and dsw_wind on the JW06 model's own inputs (its terrain
    in the context's metrics): 0.0 from their plain versions."""
    from geosongpu_tpu_torch.models import baroclinic_wave

    model = baroclinic_wave.build_model(
        DycoreConfig(npx=12, npz=26, dt=1200.0, n_split=2, ntracers=0,
                     pallas_dycore=True), cuda)
    assert float(model.ctx.metrics.phis.abs().max()) > 1e3
    _equal_to_plain(name, _model_args(model, cuda)[name])


# ---- the column-physics kernels --------------------------------------------

GATE_KERNELS = ("FillQ2Zero", "Buoyancy", "EvapSublPdfLoop", "AerActivation",
                "GFDLMicrophysics", "MoistRadCoup", "CupGfSh")


def _column_case(name, lead, K, seed, dev):
    """(wrapper, plain version, arguments) of the physics gate's kernel
    `name` on the gate's sounding, reshaped to the leading shape `lead`."""
    import sys

    from geosongpu_tpu_torch.physics import standalone_gate as gate

    d = {k: torch.as_tensor(v.reshape(lead + (K,)), device=dev)
         for k, v in gate.datasets(seed, (int(np.prod(lead)), K)).items()}
    kern = gate.WRAPPERS[name]
    plain = getattr(sys.modules[kern.__module__], kern.__name__ + "_plain")
    return kern, plain, gate.arguments(name, d)


def _tensors(out):
    if isinstance(out, dict):
        return list(out.values())
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("lead,K", [((128,), 40), ((123,), 16),
                                    ((2, 3, 5), 9), ((7,), 2)])
@pytest.mark.parametrize("name", GATE_KERNELS)
def test_column_kernel_matches_plain(cuda, name, lead, K):
    """Within 1e-5 of max|plain| per output, at the gate's shape, ragged
    column counts, a leading shape of three axes and two levels."""
    kern, plain, args = _column_case(name, lead, K, 1000 + K, cuda)
    before = kern.launches
    got = _tensors(kern(*args))
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = _tensors(plain(*args))
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32, (name, n)
        assert bool(g.isfinite().all()), (name, n)
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max()), \
            (name, n)


@pytest.mark.parametrize("name", GATE_KERNELS)
def test_column_wrapper_rejects_bad_inputs(cuda, name):
    kern, _, args = _column_case(name, (6, 4), 8, 3, cuda)
    a = list(args)
    with pytest.raises(TypeError):
        kern(*([a[0].double()] + a[1:]))
    with pytest.raises(ValueError):
        kern(*(a[:1] + [a[1][..., :-1].contiguous()] + a[2:]))
    # a strided view, as state.q[..., 0] is: refused, not copied silently
    strided = torch.stack([a[0], a[0]], dim=-1)[..., 0]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kern(*([strided] + a[1:]))


@pytest.mark.parametrize("name", GATE_KERNELS)
def test_physics_gate_on_card(cuda, name):
    """The dual-build gate with the CUDA kernel as its second build."""
    from geosongpu_tpu_torch.physics import standalone_gate as gate

    worst = gate.run_gate(name, cuda)
    assert 0.0 <= worst <= gate.REL_TOL


# ---- gfdl_microphysics and fill_q2_zero on tiles of columns ---------------

TILE_KS = [1, 2, 31, 32, 33, 72, 129]
# 1, C - 1, C and C + 1 for tiles of 16 columns (gfdl_microphysics at K
# 129) and of 32 (the others), and a ragged 123
TILE_NCOLS = [1, 15, 16, 17, 31, 32, 33, 123]


def _sounding(ncol, K, seed, dev):
    """The physics gate's sounding at (ncol, K) for any K >= 1 (its recipe
    takes two levels at least: one level is the top one of two)."""
    from geosongpu_tpu_torch.physics import standalone_gate as gate

    d = gate.datasets(seed, (ncol, max(K, 2)))
    return {k: torch.as_tensor(np.ascontiguousarray(v[:, :K]), device=dev)
            for k, v in d.items()}


def _equals_plain(name, args, plain_args=None):
    """The gate kernel `name` on `args`: one launch, every output equal to
    the plain version's (on `plain_args`, default `args`) in every
    element; -> the outputs."""
    import sys

    from geosongpu_tpu_torch.physics import standalone_gate as gate

    kern = gate.WRAPPERS[name]
    plain = getattr(sys.modules[kern.__module__], kern.__name__ + "_plain")
    before = kern.launches
    got = _tensors(kern(*args))
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = _tensors(plain(*(plain_args or args)))
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and bool(g.isfinite().all()), (name, n)
        assert torch.equal(g, w), (name, n, float((g - w).abs().max()))
    return got


@pytest.mark.parametrize("ncol", TILE_NCOLS)
@pytest.mark.parametrize("K", TILE_KS)
@pytest.mark.parametrize("name", ["GFDLMicrophysics", "FillQ2Zero"])
def test_column_tile_kernel_equals_plain(cuda, name, K, ncol):
    """Every output equal to the plain version's in every element, at the
    tile's edges and at a ragged column count."""
    from geosongpu_tpu_torch.physics import standalone_gate as gate

    _equals_plain(name, gate.arguments(
        name, _sounding(ncol, K, 2000 + K + ncol, cuda)))


# ---- cup_gf_sh and aer_activation: runs of points ------------------------

POINT_KS = [1, 2, 3, 31, 32, 33, 72, 129]
# with the K above: flat sizes below, at and across a block's run of 128
# points, so that a column crosses the edge of a run
POINT_NCOLS = [1, 3, 31, 32, 33, 255, 257]
RUN_KERNELS = ["CupGfSh", "AerActivation"]


@pytest.mark.parametrize("ncol", POINT_NCOLS)
@pytest.mark.parametrize("K", POINT_KS)
@pytest.mark.parametrize("name", RUN_KERNELS)
def test_pointwise_kernel_equals_plain(cuda, name, K, ncol):
    """Every output equal to the plain version's in every element, across
    cup_gf_sh's runs of points and the neighbour on each side of a run."""
    from geosongpu_tpu_torch.physics import standalone_gate as gate

    _equals_plain(name, gate.arguments(
        name, _sounding(ncol, K, 4000 + K + ncol, cuda)))


def _off_by_four_bytes(x):
    """A contiguous copy of x whose data_ptr() is 4 bytes past a 16-byte
    boundary: the view [1:1 + n] of a fresh flat buffer."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    v = buf[1:1 + x.numel()].view(x.shape)
    v.copy_(x)
    return v


@pytest.mark.parametrize("ncol,K", [(1, 1), (3, 2), (31, 33), (257, 3),
                                    (255, 72), (1000, 32), (16385, 129)])
@pytest.mark.parametrize("name", RUN_KERNELS)
def test_pointwise_kernel_unaligned_inputs(cuda, name, ncol, K):
    """Inputs 4 bytes off a 16-byte boundary (contiguous views such as
    x[1:]): one launch, equal to the plain version and to the aligned call
    in every element."""
    from geosongpu_tpu_torch.physics import standalone_gate as gate

    args = gate.arguments(name, _sounding(ncol, K, 5000 + K + ncol, cuda))
    moved = tuple(_off_by_four_bytes(a) if isinstance(a, torch.Tensor)
                  else a for a in args)
    assert all(a.data_ptr() % 16 == 4 for a in moved
               if isinstance(a, torch.Tensor))
    got = _equals_plain(name, moved, args)
    for g, a in zip(got, _tensors(gate.WRAPPERS[name](*args))):
        assert torch.equal(g, a)


# aer_activation's smax sits on a clamp for every w <= 0 and every w at or
# above 21.6 (0.01 w^0.75 >= 0.1), and a warp whose points all do takes
# the block's two clamp fractions instead of the powf, logf and erff: w all
# on the lower clamp (zeros of both signs among them), all above the upper
# one, clamps and free points mixed within each warp, and runs of 32 and 48
# clamped points (whole warps, and warps half of each kind), at flat sizes
# that end inside a block's run of points and on views 4 bytes off a
# 16-byte boundary; 14,564 x 72 takes the form of four points a thread.
AER_W = ["lower", "upper", "mixed", "runs"]


def _aer_w(form, w):
    rng = np.random.default_rng(17)
    n = w.numel()
    if form == "lower":
        x = -w.cpu().numpy()
        x.reshape(-1)[::7] = 0.0
        x.reshape(-1)[3::7] = -0.0
    elif form == "upper":
        x = w.cpu().numpy() + 21.6
    elif form == "mixed":
        x = rng.choice(np.array([-1.0, -0.0, 0.0, 1e-5, 0.5, 21.5, 21.6,
                                 25.0, 100.0], np.float32), n)
    else:
        e = np.arange(n)
        x = np.where((e % 64 < 32) | (e % 96 < 48), -1.0,
                     w.cpu().numpy().reshape(-1))
    return torch.as_tensor(np.asarray(x, np.float32).reshape(w.shape),
                           device=w.device)


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "off4"])
@pytest.mark.parametrize("ncol,K", [(1, 1), (3, 33), (257, 3), (1000, 32),
                                    (2049, 72), (14564, 72)])
@pytest.mark.parametrize("form", AER_W)
def test_aer_activation_clamps_equal_plain(cuda, form, ncol, K, offset):
    d = _sounding(ncol, K, 6000 + K + ncol, cuda)
    d["w"] = _aer_w(form, d["w"])
    from geosongpu_tpu_torch.physics import standalone_gate as gate

    args = gate.arguments("AerActivation", d)
    if offset:
        args = tuple(_off_by_four_bytes(a) if isinstance(a, torch.Tensor)
                     else a for a in args)
    _equals_plain("AerActivation", args)


def _tracer_array(lead, K, nq, seed, dev):
    """(q [..., K, nq] as the model state lays it out, delp [..., K]), with
    negative values in every tracer."""
    rng = np.random.default_rng(seed)
    q = rng.normal(1e-4, 3e-4, lead + (K, nq)).astype(np.float32)
    dp = np.linspace(500.0, 2500.0, K, dtype=np.float32)
    delp = (dp * (1.0 + 0.2 * rng.random(lead + (K,)))).astype(np.float32)
    return torch.as_tensor(q, device=dev), torch.as_tensor(delp, device=dev)


@pytest.mark.parametrize("K", [1, 2, 32, 72, 129])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_fill_tracers_equals_single_field(cuda, n, K):
    """The multi-tracer form on a [..., K, 3] tracer array: one launch,
    each output equal to the single-field kernel on the contiguous copy of
    its tracer and to the plain version."""
    from geosongpu_tpu_torch.ops.kernels import columns as kcol

    q, delp = _tracer_array((6, 8, 9), K, 3, 100 * K + n, cuda)
    before = kcol.fill_q2_zero.launches
    got = kcol.fill_q2_zero_tracers(q, delp, n)
    torch.cuda.synchronize()
    assert kcol.fill_q2_zero.launches == before + 1
    assert len(got) == n
    for t, g in enumerate(got):
        assert g.shape == delp.shape and g.is_contiguous()
        assert torch.equal(g, kcol.fill_q2_zero(q[..., t].contiguous(),
                                                delp)), t
        assert torch.equal(g, kcol.fill_q2_zero_plain(q[..., t], delp)), t


def test_fill_tracers_rejects_bad_inputs(cuda):
    from geosongpu_tpu_torch.ops.kernels import columns as kcol

    q, delp = _tracer_array((2, 3), 8, 3, 7, cuda)
    fill = kcol.fill_q2_zero_tracers
    with pytest.raises(TypeError):
        fill(q.double(), delp, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fill(q.transpose(-1, -2).contiguous().transpose(-1, -2), delp, 3)
    with pytest.raises(ValueError):
        fill(q[..., :-1, :].contiguous(), delp, 3)   # another K
    with pytest.raises(ValueError):
        fill(q[..., 0].contiguous(), delp, 1)        # no tracer axis
    for n in (0, 4, 2.0):
        with pytest.raises(ValueError):
            fill(q, delp, n)
    with pytest.raises(ValueError):
        fill(q, delp.cpu(), 3)


def test_fused_aquaplanet_on_card_matches_cpu(cuda):
    """3 steps at c8-L12 from a moist-perturbed numpy state: on the card
    through the substep kernels, dsw_tracer_acc per tracer, fill_q2_zero
    (the three tracers in one launch a step), cup_gf_sh and
    gfdl_microphysics (1 per step each); ql and qr relative to max|qv|."""
    from geosongpu_tpu_torch.models import aquaplanet
    from geosongpu_tpu_torch.ops.kernels.columns import (cup_gf_sh,
                                                         fill_q2_zero)
    from geosongpu_tpu_torch.ops.kernels.microphysics import \
        gfdl_microphysics

    cfg = DycoreConfig(npx=8, npz=12, dt=1200.0, n_split=4, ntracers=3,
                       pallas_dycore=True, pallas_microphysics=True)
    m_cpu = aquaplanet.build_model(cfg, "cpu")
    m_gpu = aquaplanet.build_model(cfg, cuda)
    start = state_to_numpy(m_cpu.init(perturb=3.0))
    rng = np.random.default_rng(5)
    lead = start["q"].shape[:-1]
    start["q"][..., 0] *= (1.0 + 0.9 * rng.random(lead)).astype(np.float32)
    start["q"][..., 1] = (3e-4 * rng.random(lead)).astype(np.float32)
    start["q"][..., 2] = (1e-4 * rng.random(lead)).astype(np.float32)
    a = state_to_numpy(m_cpu.run(state_from_numpy(start, "cpu"), 3))
    kernels = [dsw.dsw_csw1, dsw.dsw_tracer_acc, remap_banded, fill_q2_zero,
               cup_gf_sh, gfdl_microphysics]
    before = [k.launches for k in kernels]
    b = state_to_numpy(m_gpu.run(state_from_numpy(start, cuda), 3))
    assert [k.launches - b0 for k, b0 in zip(kernels, before)] \
        == [3 * n for n in (cfg.n_split, 3 * cfg.q_split, 3, 1, 1, 1)]
    for f in ("u", "v", "delp", "pt", "ps"):
        scale = float(np.abs(a[f]).max())
        atol = 6e-3 if f in ("u", "v") else 0.0
        assert float(np.abs(a[f] - b[f]).max()) <= max(1e-4 * scale, atol), f
    qv_max = float(np.abs(a["q"][..., 0]).max())
    assert float(np.abs(a["q"] - b["q"]).max()) <= 1e-4 * qv_max
    assert b["q"][..., 1].max() > 1e-4 and b["q"][..., 2].max() > 1e-5


# ---- the hardware sampler's readings of the card --------------------------

def _load(cuda, seconds, between=None):
    """Chained float32 matmuls on the card for `seconds`, calling
    `between()` after each synchronised batch."""
    a = torch.randn(4096, 4096, device=cuda)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(4):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize(cuda)
        if between is not None:
            between()
    return a


def test_nvml_handle_is_the_torch_device(cuda):
    from geosongpu_tpu_torch.hws.nvml import NVML, Device, torch_uuid

    index = torch.cuda.current_device()
    with Device(cuda) as dev:
        assert dev.uuid == torch_uuid(index)
        assert dev.uuid.startswith("GPU-")
        assert dev.name == torch.cuda.get_device_name(index)
        assert 0.0 < dev.power_limit_w <= 1000.0
        assert 0.0 < dev.power_w() <= 1.05 * dev.power_limit_w
        assert dev.memory_used_mb() > 0.0
    with NVML() as nvml:
        assert nvml.driver_version()


def test_energy_counter_never_decreases(cuda):
    from geosongpu_tpu_torch.hws.nvml import Device

    with Device(cuda) as dev:
        reads = [dev.energy_mj()]
        _load(cuda, 1.5, lambda: reads.append(dev.energy_mj()))
        reads.append(dev.energy_mj())
    assert all(b >= a for a, b in zip(reads, reads[1:]))
    assert reads[-1] > reads[0]


def test_busy_rises_under_load_and_falls_when_idle(cuda):
    from geosongpu_tpu_torch.hws.server import Sampler

    sampler = Sampler(rate_s=0.2, device=cuda)
    try:
        def idle(n):
            for _ in range(n):
                sampler.sample_once()
                time.sleep(0.2)

        idle(6)
        n0 = len(sampler.data["tpu_busy"])
        last = [time.perf_counter()]

        def sample_every_rate():
            if time.perf_counter() - last[0] >= 0.2:
                sampler.sample_once()
                last[0] = time.perf_counter()

        _load(cuda, 2.5, sample_every_rate)
        n1 = len(sampler.data["tpu_busy"])
        time.sleep(1.5)
        idle(6)
    finally:
        sampler.close()
    busy = np.asarray(sampler.data["tpu_busy"])
    before, load, after = busy[:n0], busy[n0:n1], busy[n1:]
    assert len(load) >= 5
    assert load.mean() > before.mean() and load.mean() > after.mean()
    assert load.max() > 0.5 and after.min() < 0.5


def test_checkpoint_resume_on_card_is_bitwise(cuda, tmp_path):
    """The fused c8-L8 model on the card: 4 steps straight equal 2 steps,
    save, restore onto the card into a freshly built model and 2 more,
    bit for bit."""
    from geosongpu_tpu_torch.harness import checkpoint

    cfg = DycoreConfig(npx=8, npz=8, dt=600.0, n_split=2, pallas_dycore=True)
    model = build_model(cfg, cuda)
    s0 = model.init(perturb=0.01)
    straight = state_to_numpy(model.run(s0, 4))
    checkpoint.save(str(tmp_path), model.run(s0, 2), cfg, step=2)
    restored, step = checkpoint.restore(str(tmp_path), cuda)
    assert step == 2 and restored.u.device.type == "cuda"
    resumed = state_to_numpy(build_model(cfg, cuda).run(restored, 2))
    for name, a in straight.items():
        np.testing.assert_array_equal(resumed[name], a, err_msg=name)


def test_bridge_layout_check_with_the_hook_on_card(cuda, tmp_path):
    """The coordinate-stamp case of tests/test_torch_interop.py with the
    hook's tensors on the card: every array element checked in the port's
    layout on the card and written back negated through the card."""
    import os
    import shutil
    import subprocess

    from geosongpu_tpu_torch.interop import dycore
    from geosongpu_tpu_torch.interop.generator import Bridge

    if shutil.which("gcc") is None:
        pytest.skip("no gcc")
    d = str(tmp_path)
    Bridge.from_file(os.path.join(os.path.dirname(dycore.__file__),
                                  "def_dycore.json")).write(d)
    dycore.write_hook(d, 'LayoutCheckHook("cuda")')
    host = dycore.build_host(d)
    r = subprocess.run([host, "stamp", d, "7", "6", "3"], capture_output=True,
                       text=True, cwd=d, env=dycore.host_env(d), timeout=300)
    assert r.returncode == 0, f"rc={r.returncode}:\n{r.stderr}\n{r.stdout}"
    assert "HOST_OK" in r.stdout

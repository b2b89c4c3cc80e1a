"""C/D-grid shallow-water substep (geosongpu_tpu/dycore/sw.py).

One acoustic substep is the Lin-Rood two-grid scheme: c_sw advances the
C-grid winds half a step to get time-centred advective winds; d_sw then
transports delp/pt with PPM fluxes and updates the D-grid winds with the
vorticity flux, the corner KE gradient, divergence damping (the exchange
form or the in-kernel blend) and the backward PGF.  In nonhydrostatic
mode the transport also carries w and delz, the implicit vertical
acoustic solve (nh_solver.py) follows it, and the PGF gains the p',
phi' and rho terms of the solved state; with advect_tracers the tracers
ride every substep.  All functions work on padded [6, J, I, K] tensors and
keep the reference's names, so each one has a counterpart to be held
against.  The functions are the plain PyTorch versions of the substep
kernels dsw_csw1 (c_sw_part1), dsw_csw2 (c_sw_part2), dsw_transport
(transport_part), dsw_wind (wind_part, nh_perturbation_fields) and
nh_vertical_solve (nh_vertical_glue).

Not here: the rim-split c_sw, which only pays where the D-grid exchange
can overlap the core (an asynchronous transport across devices; the
port's rank groups exchange synchronously, so `rim_split` runs the
unsplit c_sw, fv_dynamics.py), and the strip form of a_grid_winds, a
memory optimisation of the reference documented as bit-identical to the
full-array form used here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.grid import CP_AIR, GRAV, KAPPA, RDGAS, Grid
from ..core.topology import NFACES
from ..device import to_torch
from ..ops.fvtp2d import ddx, ddy, fvtp2d
from ..ops.ppm import ppm_flux, upwind_flux
from ..ops.vertical import interfaces_from_delp, rcumsum_k
from ..parallel.halo import HaloOps
from ..spans import span, spanned
from .nh_solver import vertical_acoustic_solve

P00 = 1.0e5


class PaddedMetrics(NamedTuple):
    """Padded grid arrays used every substep, each [6, R, C, 1] float32
    (div_blend too); see the reference's PaddedMetrics for each field."""

    area: torch.Tensor
    rarea: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dxc: torch.Tensor
    dyc: torch.Tensor
    fcor: torch.Tensor
    rarea_c: torch.Tensor
    cosa_i: torch.Tensor
    rsina_i: torch.Tensor
    cosa_j: torch.Tensor
    rsina_j: torch.Tensor
    rdx: torch.Tensor
    rdy: torch.Tensor
    rdxc: torch.Tensor
    rdyc: torch.Tensor
    cosa_c: torch.Tensor
    rsin2_c: torch.Tensor
    cosa_cn: torch.Tensor
    rsin2_cn: torch.Tensor
    phis: torch.Tensor
    dw00: torch.Tensor
    dw01: torch.Tensor
    dw10: torch.Tensor
    dw11: torch.Tensor
    dr11: torch.Tensor
    r12: torch.Tensor
    r21: torch.Tensor
    dr22: torch.Tensor
    jwm: torch.Tensor
    jwp: torch.Tensor
    iwm: torch.Tensor
    iwp: torch.Tensor
    rdxc_c: torch.Tensor
    rdyc_c: torch.Tensor
    div_blend: torch.Tensor


def padded_metrics(grid: Grid, device, phis=None,
                   chart_cosa: bool = False) -> PaddedMetrics:
    """phis: the unpadded surface geopotential [6, n, n] (terrain), padded
    here through the scalar gather table; None: flat.  chart_cosa:
    basis-angle metrics evaluated at the chart gridpoints in the
    cube-corner regions, as the reference does under chart_corners.  Every
    array is cast to float32 before any reciprocal is taken."""
    a = lambda x: to_torch(x, device)[..., None]
    r = lambda x: (1.0 / to_torch(x, device))[..., None]
    if phis is None:
        phis_pad = np.zeros(grid.area.shape, np.float32)
    else:
        phis_pad = np.asarray(phis, np.float32).reshape(-1)[grid.spec.gidx_x]
    cosa_i, rsina_i = grid.cosa_i, grid.rsina_i
    cosa_j, rsina_j = grid.cosa_j, grid.rsina_j
    cosa_c, rsin2_c = grid.cosa_c, grid.rsin2_c
    cosa_cn, rsin2_cn = grid.cosa_cn, grid.rsin2_cn
    corner_dw = grid.corner_dw
    if chart_cosa:
        from ..core.chart_corners import (chart_corner_dw,
                                          chart_cosa_overrides)

        ov = chart_cosa_overrides(grid.n, grid.h)

        def blend(name, base, base_r, power):
            vals, mask = ov[name]
            rs = 1.0 / np.maximum(1.0 - vals ** 2, 0.25) ** (0.5 * power)
            return (np.where(mask, vals, base).astype(np.float32),
                    np.where(mask, rs, base_r).astype(np.float32))
        cosa_i, rsina_i = blend("cosa_i", cosa_i, rsina_i, 1)
        cosa_j, rsina_j = blend("cosa_j", cosa_j, rsina_j, 1)
        cosa_c, rsin2_c = blend("cosa_c", cosa_c, rsin2_c, 2)
        cosa_cn, rsin2_cn = blend("cosa_cn", cosa_cn, rsin2_cn, 2)
        corner_dw = chart_corner_dw(grid.n, grid.h)
    ap = _pad_edge(_pad_edge(to_torch(grid.area, device), 1), 2)
    area_c = 0.25 * (ap[:, :-1, :-1] + ap[:, :-1, 1:] + ap[:, 1:, :-1]
                     + ap[:, 1:, 1:])
    # damping-divergence blend mask: face-edge corner rows/cols and the
    # cube-corner disks
    n_, h_ = grid.n, grid.h
    Nc = n_ + 2 * h_ + 1
    iy, ix = np.meshgrid(np.arange(Nc), np.arange(Nc), indexing="ij")
    de_ = np.minimum.reduce([np.abs(iy - h_), np.abs(iy - h_ - n_),
                             np.abs(ix - h_), np.abs(ix - h_ - n_)])
    cd_ = np.minimum.reduce([
        np.hypot(iy - h_, ix - h_), np.hypot(iy - h_, ix - h_ - n_),
        np.hypot(iy - h_ - n_, ix - h_),
        np.hypot(iy - h_ - n_, ix - h_ - n_)])
    div_blend = np.broadcast_to(
        ((de_ <= 1) | (cd_ <= 4.0)).astype(np.float32)[None],
        (NFACES, Nc, Nc))
    return PaddedMetrics(
        area=a(grid.area), rarea=a(grid.rarea),
        dx=a(grid.dx), dy=a(grid.dy), dxc=a(grid.dxc), dyc=a(grid.dyc),
        fcor=a(grid.fcor),
        rarea_c=(1.0 / area_c)[..., None],
        cosa_i=a(cosa_i), rsina_i=a(rsina_i),
        cosa_j=a(cosa_j), rsina_j=a(rsina_j),
        rdx=r(grid.dx), rdy=r(grid.dy), rdxc=r(grid.dxc), rdyc=r(grid.dyc),
        cosa_c=a(cosa_c), rsin2_c=a(rsin2_c),
        cosa_cn=a(cosa_cn), rsin2_cn=a(rsin2_cn),
        phis=a(phis_pad),
        dw00=a(corner_dw[0]), dw01=a(corner_dw[1]),
        dw10=a(corner_dw[2]), dw11=a(corner_dw[3]),
        dr11=a(grid.dr11), r12=a(grid.r12), r21=a(grid.r21),
        dr22=a(grid.dr22),
        jwm=a(grid.jwm), jwp=a(grid.jwp), iwm=a(grid.iwm), iwp=a(grid.iwp),
        rdxc_c=r(grid.dxc_c), rdyc_c=r(grid.dyc_c),
        div_blend=a(div_blend),
    )


class SWState(NamedTuple):
    """Padded prognostic fields for one substep."""

    pu: torch.Tensor     # [6, N+1, N, K]
    pv: torch.Tensor     # [6, N, N+1, K]
    pd_x: torch.Tensor   # [6, N, N, K] delp, x-order corners
    pd_y: torch.Tensor
    pt_x: torch.Tensor
    pt_y: torch.Tensor
    pq_x: Optional[torch.Tensor] = None  # tracers [6, N, N, K, T]
    pq_y: Optional[torch.Tensor] = None
    # nonhydrostatic prognostics (None in hydrostatic mode)
    pw_x: Optional[torch.Tensor] = None  # vertical velocity [6, N, N, K]
    pw_y: Optional[torch.Tensor] = None
    pz_x: Optional[torch.Tensor] = None  # layer thickness delz > 0
    pz_y: Optional[torch.Tensor] = None


def fill_substep(ops: HaloOps, u, v, delp, pt, q=None, w=None, delz=None,
                 chart=None) -> SWState:
    """Halo-filled substep inputs; q (per-substep tracers), w and delz
    (nonhydrostatic) are filled when given.  With chart corners the
    corrected x-fill serves both stencil directions (x- and y-fills agree
    after it)."""
    pu, pv = ops.fill_dgrid(u, v)

    def fx(a):
        if a is None:
            return None
        out = ops.fill(a, "x")
        return chart.apply_scalar(out, "x") if chart is not None else out

    def fy(a, same):
        if a is None:
            return None
        return same if chart is not None else ops.fill(a, "y")

    pd_x, pt_x, pq_x, pw_x, pz_x = fx(delp), fx(pt), fx(q), fx(w), fx(delz)
    return SWState(pu=pu, pv=pv, pd_x=pd_x, pd_y=fy(delp, pd_x),
                   pt_x=pt_x, pt_y=fy(pt, pt_x),
                   pq_x=pq_x, pq_y=fy(q, pq_x),
                   pw_x=pw_x, pw_y=fy(w, pw_x),
                   pz_x=pz_x, pz_y=fy(delz, pz_x))


# --------------------------------------------------------------------------
# staggering helpers (padded arrays)
# --------------------------------------------------------------------------

def _avg_u_to_center(pu):
    return 0.5 * (pu[:, :-1, :] + pu[:, 1:, :])


def _avg_v_to_center(pv):
    return 0.5 * (pv[:, :, :-1] + pv[:, :, 1:])


def _center_to_xiface(a):
    mid = 0.5 * (a[:, :, :-1] + a[:, :, 1:])
    return torch.cat([a[:, :, :1], mid, a[:, :, -1:]], dim=2)


def _center_to_yiface(a):
    mid = 0.5 * (a[:, :-1, :] + a[:, 1:, :])
    return torch.cat([a[:, :1, :], mid, a[:, -1:, :]], dim=1)


def _pad_edge(a, dim: int, before: int = 1, after: int = 1):
    """Edge-replication pad along `dim`."""
    n = a.shape[dim]
    parts = ([a.narrow(dim, 0, 1)] * before + [a]
             + [a.narrow(dim, n - 1, 1)] * after)
    return torch.cat(parts, dim=dim)


def _resample_y_strip(a, jwm, jwp):
    am = _pad_edge(a, 1, before=1, after=0)[:, :-1]
    ap = _pad_edge(a, 1, before=0, after=1)[:, 1:]
    return a + (jwm * (am - a) + jwp * (ap - a))


def _resample_x_strip(a, iwm, iwp):
    am = _pad_edge(a, 2, before=1, after=0)[:, :, :-1]
    ap = _pad_edge(a, 2, before=0, after=1)[:, :, 1:]
    return a + (iwm * (am - a) + iwp * (ap - a))


def _resample_to_chart(a, m: PaddedMetrics):
    """Re-attach halo cell-centre samples to the extended-chart gridpoints
    (3-point Lagrange in deviation form, y then x; exact zeros in the
    interior)."""
    return _resample_x_strip(_resample_y_strip(a, m.jwm, m.jwp),
                             m.iwm, m.iwp)


def _center_to_corner_w(a, m: PaddedMetrics):
    """Geometry-exact centre -> corner interpolation: the 4-point average
    plus the linear-exactness correction sum_k dw_k (a_k - avg4)."""
    ap = _pad_edge(_pad_edge(a, 1), 2)
    a00, a01 = ap[:, :-1, :-1], ap[:, :-1, 1:]
    a10, a11 = ap[:, 1:, :-1], ap[:, 1:, 1:]
    avg4 = 0.25 * (a00 + a01 + a10 + a11)
    return avg4 + (m.dw00 * (a00 - avg4) + m.dw01 * (a01 - avg4)
                   + m.dw10 * (a10 - avg4) + m.dw11 * (a11 - avg4))


class StagResample(NamedTuple):
    """Staggered-halo chart resample weights, each [6, R, C, 1]."""

    su_jwm: torch.Tensor
    su_jwp: torch.Tensor
    su_iwm: torch.Tensor
    su_iwp: torch.Tensor
    sv_jwm: torch.Tensor
    sv_jwp: torch.Tensor
    sv_iwm: torch.Tensor
    sv_iwp: torch.Tensor
    corner_disk: torch.Tensor   # [6, N+1, N+1, 1] bool


def stag_resample_tables(grid: Grid, device) -> StagResample:
    """The staggered resample weights of the grid and the cube-corner disks
    (radius 4 cells) where the damping takes the cell divergence."""
    f = lambda a: to_torch(a, device)[..., None]
    n, h = grid.n, grid.h
    N = n + 2 * h
    iy, ix = np.meshgrid(np.arange(N + 1), np.arange(N + 1), indexing="ij")
    cd = np.minimum.reduce([
        np.hypot(iy - h, ix - h), np.hypot(iy - h, ix - h - n),
        np.hypot(iy - h - n, ix - h), np.hypot(iy - h - n, ix - h - n)])
    disk = np.broadcast_to((cd <= 4.0)[None], (6, N + 1, N + 1))
    return StagResample(
        su_jwm=f(grid.su_jwm), su_jwp=f(grid.su_jwp),
        su_iwm=f(grid.su_iwm), su_iwp=f(grid.su_iwp),
        sv_jwm=f(grid.sv_jwm), sv_jwp=f(grid.sv_jwp),
        sv_iwm=f(grid.sv_iwm), sv_iwp=f(grid.sv_iwp),
        corner_disk=f(disk))


def _zero_pad(a, rows, cols):
    """Zero-pad dims 1 and 2 of [F, R, C, K] by (before, after) pairs."""
    return torch.nn.functional.pad(a, (0, 0, cols[0], cols[1],
                                       rows[0], rows[1]))


def _strip_chart_resample(a, jwm, jwp, iwm, iwp, b: int):
    """Band-confined two-pass chart resample of a scalar on any grid:
    j-resample on the W/E column bands (width b), then i-resample on the
    S/N row bands using the y-resampled corner values.  Values outside
    the b-wide frame pass through bit-exactly; the outermost rows/cols are
    identity (a centred 3-point stencil has no neighbours there)."""
    Ny, Nx = a.shape[1], a.shape[2]
    dev = a.device
    rmask = torch.ones((1, Ny, 1, 1), dtype=a.dtype, device=dev)
    rmask[:, 0] = rmask[:, -1] = 0.0
    cmask = torch.ones((1, 1, Nx, 1), dtype=a.dtype, device=dev)
    cmask[:, :, 0] = cmask[:, :, -1] = 0.0
    jwm, jwp = jwm * rmask, jwp * rmask
    iwm, iwp = iwm * cmask, iwp * cmask
    parts = []
    ys = {}
    for c0, c1 in ((0, b), (Nx - b, Nx)):
        sy = _resample_y_strip(a[:, :, c0:c1], jwm[:, :, c0:c1],
                               jwp[:, :, c0:c1])
        parts.append(_zero_pad(sy[:, b:Ny - b], (b, b), (c0, Nx - c1)))
        ys[c0] = sy
    yW, yE = ys[0], ys[Nx - b]
    for r0, r1 in ((0, b), (Ny - b, Ny)):
        s = torch.cat([yW[:, r0:r1], a[:, r0:r1, b:Nx - b], yE[:, r0:r1]],
                      dim=2)
        sx = _resample_x_strip(s, iwm[:, r0:r1], iwp[:, r0:r1])
        parts.append(_zero_pad(sx, (r0, Ny - r1), (0, 0)))
    frame = torch.zeros((1, Ny, Nx, 1), dtype=torch.bool, device=dev)
    frame[:, :b] = True
    frame[:, Ny - b:] = True
    frame[:, :, :b] = True
    frame[:, :, Nx - b:] = True
    return torch.where(frame, sum(parts[1:], parts[0]), a)


def damping_normal_fields(pu, pv, ua, va, m: PaddedMetrics, ops: HaloOps,
                          tabs: StagResample):
    """Chart-consistent normal-velocity fields for the corner-dual damping
    divergence: normal fields on each face's own interior, exchanged as a
    tangential-type pair, then re-attached to the chart's staggered points.
    Returns (p_nu [6, N+1, N, K], p_nv [6, N, N+1, K])."""
    h, ny, nx = ops.h, ops.ny, ops.nx
    vu = _center_to_yiface(va)
    uv = _center_to_xiface(ua)
    nu = (pu - m.cosa_j * vu) * m.rsina_j
    nv = (pv - m.cosa_i * uv) * m.rsina_i
    p_nu, p_nv = ops.fill_dgrid(nu[:, h:h + ny + 1, h:h + nx],
                                nv[:, h:h + ny, h:h + nx + 1])
    p_nu = _strip_chart_resample(p_nu, tabs.su_jwm, tabs.su_jwp,
                                 tabs.su_iwm, tabs.su_iwp, h)
    p_nv = _strip_chart_resample(p_nv, tabs.sv_jwm, tabs.sv_jwp,
                                 tabs.sv_iwm, tabs.sv_iwp, h)
    return p_nu, p_nv


@spanned("damping_divergence")
def damping_divergence(pu, pv, ua, va, uct, vct, m: PaddedMetrics,
                       ops: HaloOps, tabs: StagResample):
    """Padded corner-grid divergence for the damping operator (the
    exchange form): the corner-dual contour of the exchanged + resampled
    normal fields, with the 8 cube-corner disks taken from the
    corner-interpolated cell divergence of uct/vct."""
    p_nu, p_nv = damping_normal_fields(pu, pv, ua, va, m, ops, tabs)
    uf = p_nu * m.dyc
    vf = p_nv * m.dxc
    du = uf[:, :, 1:] - uf[:, :, :-1]
    dv = vf[:, 1:, :] - vf[:, :-1, :]
    div_core = (du[:, 1:-1, :] + dv[:, :, 1:-1]) * m.rarea_c[:, 1:-1, 1:-1]
    div_c = _pad_edge(_pad_edge(div_core, 1), 2)
    div_cell = -(ddx(uct * m.dy) + ddy(vct * m.dx)) * m.rarea
    div_a = _center_to_corner_w(div_cell, m)
    return torch.where(tabs.corner_disk, div_a, div_c)


def _vorticity_abs(pu, pv, m: PaddedMetrics):
    """Absolute vorticity at cell centres (primal-cell circulation)."""
    circ = (pu[:, :-1, :] * m.dx[:, :-1, :]
            + pv[:, :, 1:] * m.dy[:, :, 1:]
            - pu[:, 1:, :] * m.dx[:, 1:, :]
            - pv[:, :, :-1] * m.dy[:, :, :-1])
    return circ * m.rarea + m.fcor


def _hydrostatic_fields(delp, pt, ptop):
    """pe -> Exner pkz and layer-mid geopotential (flat terrain)."""
    pe = interfaces_from_delp(delp, ptop)
    pk_iface = (pe / P00) ** KAPPA
    peln = torch.log(pe)
    dpk = pk_iface[..., 1:] - pk_iface[..., :-1]
    pkz = dpk / (KAPPA * (peln[..., 1:] - peln[..., :-1]))
    dphi = CP_AIR * pt * dpk
    phi_mid = rcumsum_k(dphi) - 0.5 * dphi
    return pkz, phi_mid


# --------------------------------------------------------------------------
# c_sw: half step -> time-centred C-grid winds
# --------------------------------------------------------------------------

def _rot(ua, va, dr11, r12, r21, dr22):
    return (ua + (dr11 * ua + r12 * va),
            va + (r21 * ua + dr22 * va))


def a_grid_winds(pu, pv, m: PaddedMetrics):
    """Chart-consistent A-grid winds from the padded D-grid winds: the
    average, the halo basis rotation, then the chart resample (the
    reference's full-array form)."""
    ua = _avg_u_to_center(pu)
    va = _avg_v_to_center(pv)
    ua, va = _rot(ua, va, m.dr11, m.r12, m.r21, m.dr22)
    return _resample_to_chart(ua, m), _resample_to_chart(va, m)


def c_sw_part1(s: SWState, m: PaddedMetrics, dt2: float, ua, va):
    """C-grid normal winds, half-step upwind delp/pt, centre KE and
    absolute vorticity (body of the dsw_csw1 kernel)."""
    uc = _center_to_xiface(ua)
    vc = _center_to_yiface(va)
    va_i = _center_to_xiface(va)
    ua_j = _center_to_yiface(ua)
    uc = (uc - m.cosa_i * va_i) * m.rsina_i
    vc = (vc - m.cosa_j * ua_j) * m.rsina_j

    crx = uc * dt2 * m.rdxc
    cry = vc * dt2 * m.rdyc
    fx_m = upwind_flux(s.pd_x, crx, 2) * uc * dt2 * m.dy
    fy_m = upwind_flux(s.pd_y, cry, 1) * vc * dt2 * m.dx
    delp_h = s.pd_x + (ddx(fx_m) + ddy(fy_m)) * m.rarea
    fx_t = upwind_flux(s.pt_x, crx, 2) * fx_m
    fy_t = upwind_flux(s.pt_y, cry, 1) * fy_m
    pt_h = (s.pt_x * s.pd_x + (ddx(fx_t) + ddy(fy_t)) * m.rarea) / delp_h

    ke = 0.5 * m.rsin2_c * (ua * ua + va * va - 2.0 * m.cosa_c * ua * va)
    vort = _vorticity_abs(s.pu, s.pv, m)
    return uc, vc, delp_h, pt_h, ke, vort


def c_sw_part2(uc, vc, pt_h, pkz, phi, ke, vort, m: PaddedMetrics,
               dt2: float):
    """Interface wind update from the half-step PGF, KE gradient and
    vorticity x transverse wind -> (uc*, vc*) (body of dsw_csw2).  Inputs
    are resampled onto the chart and differenced with chart spacings."""
    pt_h = _resample_to_chart(pt_h, m)
    pkz = _resample_to_chart(pkz, m)
    phi = _resample_to_chart(phi, m)
    ke = _resample_to_chart(ke, m)
    vort = _resample_to_chart(vort, m)
    ptx = 0.5 * (pt_h[:, :, :-1] + pt_h[:, :, 1:])
    gx = ((phi[:, :, 1:] - phi[:, :, :-1])
          + CP_AIR * ptx * (pkz[:, :, 1:] - pkz[:, :, :-1])) \
        * m.rdxc_c[:, :, 1:-1]
    kex = (ke[:, :, 1:] - ke[:, :, :-1]) * m.rdxc_c[:, :, 1:-1]
    vortx = 0.5 * (vort[:, :, :-1] + vort[:, :, 1:])
    vcx = 0.25 * (vc[:, :-1, :-1] + vc[:, :-1, 1:]
                  + vc[:, 1:, :-1] + vc[:, 1:, 1:])
    uc_t = torch.cat([uc[:, :, :1],
                      uc[:, :, 1:-1] + dt2 * (vortx * vcx - kex - gx),
                      uc[:, :, -1:]], dim=2)

    pty = 0.5 * (pt_h[:, :-1, :] + pt_h[:, 1:, :])
    gy = ((phi[:, 1:, :] - phi[:, :-1, :])
          + CP_AIR * pty * (pkz[:, 1:, :] - pkz[:, :-1, :])) \
        * m.rdyc_c[:, 1:-1, :]
    key = (ke[:, 1:, :] - ke[:, :-1, :]) * m.rdyc_c[:, 1:-1, :]
    vorty = 0.5 * (vort[:, :-1, :] + vort[:, 1:, :])
    ucy = 0.25 * (uc[:, :-1, :-1] + uc[:, :-1, 1:]
                  + uc[:, 1:, :-1] + uc[:, 1:, 1:])
    vc_t = torch.cat([vc[:, :1, :],
                      vc[:, 1:-1, :] + dt2 * (-vorty * ucy - key - gy),
                      vc[:, -1:, :]], dim=1)
    return uc_t, vc_t


def c_sw(s: SWState, m: PaddedMetrics, dt2: float, ptop: float, chart=None):
    """Returns (uc*, vc*, vort, ua, va): time-centred advective normal winds
    on the C-grid plus the intermediates the d_sw stage reuses."""
    with span("agrid"):
        ua, va = a_grid_winds(s.pu, s.pv, m)
        if chart is not None:
            ua, va = chart.apply_agrid(ua, va, s.pu, s.pv)
    uc, vc, delp_h, pt_h, ke, vort = c_sw_part1(s, m, dt2, ua, va)
    if chart is not None:
        vort = chart.apply_scalar(vort, "derived")
    pkz, phi = _hydrostatic_fields(delp_h, pt_h, ptop)
    uct, vct = c_sw_part2(uc, vc, pt_h, pkz, phi + m.phis, ke, vort, m, dt2)
    return uct, vct, vort, ua, va


# --------------------------------------------------------------------------
# d_sw: full substep
# --------------------------------------------------------------------------

class SubstepOut(NamedTuple):
    u: torch.Tensor        # interior D-grid u [6, n+1, n, K]
    v: torch.Tensor
    delp: torch.Tensor     # interior [6, n, n, K]
    pt: torch.Tensor
    q: Optional[torch.Tensor]     # per-substep tracers [6, n, n, K, T]
    w: Optional[torch.Tensor]     # nonhydrostatic: solved w and delz
    delz: Optional[torch.Tensor]
    mfx: torch.Tensor      # interior mass fluxes
    mfy: torch.Tensor
    uc: torch.Tensor       # interior time-centred C-grid winds
    vc: torch.Tensor
    uct_pad: torch.Tensor  # padded, for the accumulated-flux tracers
    vct_pad: torch.Tensor
    mfx_pad: torch.Tensor
    mfy_pad: torch.Tensor
    # mid-substep x-order refills of the new state (padded)
    pd_fill: Optional[torch.Tensor] = None
    pt_fill: Optional[torch.Tensor] = None
    pz_fill: Optional[torch.Tensor] = None


def transport_part(s: SWState, m: PaddedMetrics, crx, cry, xfx, yfx,
                   hord: int, advect_tracers: bool, hord_tm: int = 0):
    """All PPM transport of one substep (body of dsw_transport, and of
    dsw_tracer per tracer): mass, heat, nonhydrostatic w (mass-weighted)
    and delz (volume form), tracers.
    Returns (delp_new, pt_new, w_adv, delz_adv, q_new, mass fluxes)."""
    hord_tm = hord_tm or hord
    rax = 1.0 / (m.area + ddx(xfx))
    ray = 1.0 / (m.area + ddy(yfx))
    mf = fvtp2d(s.pd_x, s.pd_y, crx, cry, xfx, yfx, m.area, hord=hord_tm,
                rax=rax, ray=ray)
    delp_new = s.pd_x + (ddx(mf.fx) + ddy(mf.fy)) * m.rarea
    rdelp_new = 1.0 / delp_new
    tf = fvtp2d(s.pt_x, s.pt_y, crx, cry, xfx, yfx, m.area, hord=hord_tm,
                mfx=mf.fx, mfy=mf.fy, rax=rax, ray=ray)
    pt_new = (s.pt_x * s.pd_x
              + (ddx(tf.fx) + ddy(tf.fy)) * m.rarea) * rdelp_new

    if s.pz_x is not None:
        wf = fvtp2d(s.pw_x, s.pw_y, crx, cry, xfx, yfx, m.area, hord=hord_tm,
                    mfx=mf.fx, mfy=mf.fy, rax=rax, ray=ray)
        w_adv = (s.pw_x * s.pd_x
                 + (ddx(wf.fx) + ddy(wf.fy)) * m.rarea) * rdelp_new
        zf = fvtp2d(s.pz_x, s.pz_y, crx, cry, xfx, yfx, m.area, hord=hord_tm,
                    rax=rax, ray=ray)
        delz_adv = torch.clamp(
            s.pz_x + (ddx(zf.fx) + ddy(zf.fy)) * m.rarea, min=1.0)
    else:
        w_adv = delz_adv = None

    if s.pq_x is not None and advect_tracers:
        qs = []
        for t in range(s.pq_x.shape[-1]):
            qf = fvtp2d(s.pq_x[..., t], s.pq_y[..., t], crx, cry, xfx, yfx,
                        m.area, hord=hord, mfx=mf.fx, mfy=mf.fy,
                        rax=rax, ray=ray)
            qdp = s.pq_x[..., t] * s.pd_x \
                + (ddx(qf.fx) + ddy(qf.fy)) * m.rarea
            qs.append(qdp * rdelp_new)
        q_new = torch.stack(qs, dim=-1)
    else:
        q_new = None
    return delp_new, pt_new, w_adv, delz_adv, q_new, mf


def nh_perturbation_fields(delp_new, pt_new, delz_new, ptop: float):
    """Backward p', phi' and rho from the solved nonhydrostatic state (the
    column stage of the nonhydrostatic dsw_wind).  The hydrostatic
    thickness is the discrete form of nh_solver.hydrostatic_delz
    (delp R T / p_mid), so both perturbations vanish identically in
    discrete balance."""
    pe1 = interfaces_from_delp(delp_new, ptop)
    pk1 = (pe1 / P00) ** KAPPA
    peln1 = torch.log(pe1)
    pkz1 = (pk1[..., 1:] - pk1[..., :-1]) / (
        KAPPA * (peln1[..., 1:] - peln1[..., :-1]))
    p_mid1 = 0.5 * (pe1[..., 1:] + pe1[..., :-1])
    t1 = pt_new * pkz1
    rho1 = delp_new / (GRAV * torch.clamp(delz_new, min=1.0))
    pprime = rho1 * RDGAS * t1 - p_mid1
    dphi_diff = GRAV * delz_new - RDGAS * t1 * delp_new / p_mid1
    phiprime = rcumsum_k(dphi_diff) - 0.5 * dphi_diff
    return pprime, phiprime, rho1


def wind_part(s: SWState, m: PaddedMetrics, uct, vct, crx, cry, pt_new,
              pkz, phi_mid, nh_fields, dt: float, hord: int, d2_bg: float,
              hord_mt: int = 0, vort=None, div_c_in=None,
              vtx_damp: float = 0.0):
    """D-grid vector-invariant wind update (body of dsw_wind).

    nh_fields: None, or the cell-centred (pprime, phiprime, rho1) of
    nh_perturbation_fields.  div_c_in: the exchange-form damping divergence
    (damping_divergence); None = the in-kernel dual/cell blend over
    m.div_blend.  vort: the chart-corrected centre vorticity, or None to
    recompute it.  Returns padded (u_new, v_new)."""
    phi_c = _center_to_corner_w(phi_mid, m)
    pkz_c = _center_to_corner_w(pkz, m)
    pt_c = _center_to_corner_w(pt_new, m)
    nonhydro = nh_fields is not None
    if nonhydro:
        pprime, phiprime, rho1 = nh_fields
        php_c = _center_to_corner_w(phiprime, m)
        pp_c = _center_to_corner_w(pprime, m)
        rho_c = _center_to_corner_w(rho1, m)

    ub = _pad_edge(0.5 * (uct[:, :-1, :] + uct[:, 1:, :]), 1)
    vb = _pad_edge(0.5 * (vct[:, :, :-1] + vct[:, :, 1:]), 2)
    ke_c = 0.5 * m.rsin2_cn * (ub * ub + vb * vb + 2.0 * m.cosa_cn * ub * vb)

    vort_abs = vort if vort is not None else _vorticity_abs(s.pu, s.pv, m)

    upad, vpad = s.pu, s.pv
    if div_c_in is not None:
        div_c = div_c_in
    else:
        vmid = 0.5 * (vpad[:, :, :-1] + vpad[:, :, 1:])
        vu = _pad_edge(0.5 * (vmid[:, :-1, :] + vmid[:, 1:, :]), 1)
        uf = (upad - m.cosa_j * vu) * m.rsina_j * m.dyc
        umid = 0.5 * (upad[:, :-1, :] + upad[:, 1:, :])
        uv = _pad_edge(0.5 * (umid[:, :, :-1] + umid[:, :, 1:]), 2)
        vf = (vpad - m.cosa_i * uv) * m.rsina_i * m.dxc
        du = uf[:, :, 1:] - uf[:, :, :-1]
        dv = vf[:, 1:, :] - vf[:, :-1, :]
        div_core = (du[:, 1:-1, :] + dv[:, :, 1:-1]) \
            * m.rarea_c[:, 1:-1, 1:-1]
        div_dual = _pad_edge(_pad_edge(div_core, 1), 2)
        div_cell = -(ddx(uct * m.dy) + ddy(vct * m.dx)) * m.rarea
        div_a = _center_to_corner_w(div_cell, m)
        div_c = torch.where(m.div_blend > 0.5, div_a, div_dual)

    hord_mt = hord_mt or hord
    vort_u = ppm_flux(vort_abs, cry, 1, hord_mt)
    dke_x = (ke_c[:, :, 1:] - ke_c[:, :, :-1]) * m.rdx
    pt_u = 0.5 * (pt_c[:, :, 1:] + pt_c[:, :, :-1])
    pgf_x = ((phi_c[:, :, 1:] - phi_c[:, :, :-1])
             + CP_AIR * pt_u * (pkz_c[:, :, 1:] - pkz_c[:, :, :-1])) * m.rdx
    if nonhydro:
        rho_u = torch.clamp(0.5 * (rho_c[:, :, 1:] + rho_c[:, :, :-1]),
                            min=1.0e-8)
        pgf_x = pgf_x + ((php_c[:, :, 1:] - php_c[:, :, :-1])
                         + (pp_c[:, :, 1:] - pp_c[:, :, :-1]) / rho_u) * m.rdx
    damp_x = (d2_bg / dt) * m.dx
    ddiv_x = damp_x * (div_c[:, :, 1:] - div_c[:, :, :-1])

    if vtx_damp > 0.0:
        zeta = vort_abs - m.fcor
        dvtx_u = (vtx_damp / dt) * m.dyc[:, 1:-1, :] * (
            zeta[:, 1:, :] - zeta[:, :-1, :])
        dvtx_v = (vtx_damp / dt) * m.dxc[:, :, 1:-1] * (
            zeta[:, :, 1:] - zeta[:, :, :-1])
    else:
        dvtx_u = dvtx_v = 0.0

    u_new = torch.cat(
        [upad[:, :1, :],
         upad[:, 1:-1, :] + dt * (
             vort_u[:, 1:-1, :] * vct[:, 1:-1, :]
             - dke_x[:, 1:-1, :]
             - pgf_x[:, 1:-1, :]
             + ddiv_x[:, 1:-1, :]
             - dvtx_u),
         upad[:, -1:, :]], dim=1)

    vort_v = ppm_flux(vort_abs, crx, 2, hord_mt)
    dke_y = (ke_c[:, 1:, :] - ke_c[:, :-1, :]) * m.rdy
    pt_v = 0.5 * (pt_c[:, 1:, :] + pt_c[:, :-1, :])
    pgf_y = ((phi_c[:, 1:, :] - phi_c[:, :-1, :])
             + CP_AIR * pt_v * (pkz_c[:, 1:, :] - pkz_c[:, :-1, :])) * m.rdy
    if nonhydro:
        rho_v = torch.clamp(0.5 * (rho_c[:, 1:, :] + rho_c[:, :-1, :]),
                            min=1.0e-8)
        pgf_y = pgf_y + ((php_c[:, 1:, :] - php_c[:, :-1, :])
                         + (pp_c[:, 1:, :] - pp_c[:, :-1, :]) / rho_v) * m.rdy
    damp_y = (d2_bg / dt) * m.dy
    ddiv_y = damp_y * (div_c[:, 1:, :] - div_c[:, :-1, :])

    v_new = torch.cat(
        [vpad[:, :, :1],
         vpad[:, :, 1:-1] + dt * (
             -vort_v[:, :, 1:-1] * uct[:, :, 1:-1]
             - dke_y[:, :, 1:-1]
             - pgf_y[:, :, 1:-1]
             + ddiv_y[:, :, 1:-1]
             + dvtx_v),
         vpad[:, :, -1:]], dim=2)
    return u_new, v_new


def nh_vertical_glue(w_adv, delz_adv, pt_new, delp_new, dt: float,
                     ptop: float):
    """The vertical glue between the nonhydrostatic transport and the wind
    update: interface w of the advected layer w (rigid lid and ground),
    the implicit acoustic solve, delz clamped at 1 m (as the advected
    delz is: the linearised solve may overshoot under extreme forcing),
    layer w again.  Returns (w_new, delz_new), padded.  The plain version
    of the nh_vertical_solve kernel (ops/kernels/dsw.py), which both
    substep forms call."""
    zeros_if = torch.zeros_like(w_adv[..., :1])
    w_if = torch.cat(
        [zeros_if, 0.5 * (w_adv[..., :-1] + w_adv[..., 1:]), zeros_if],
        dim=-1)
    w_if, delz_new = vertical_acoustic_solve(w_if, delz_adv, pt_new,
                                             delp_new, dt, ptop)
    delz_new = torch.clamp(delz_new, min=1.0)
    return 0.5 * (w_if[..., :-1] + w_if[..., 1:]), delz_new


def d_sw_substep(s: SWState, m: PaddedMetrics, ops: HaloOps, dt: float,
                 ptop: float, hord: int = 8, d2_bg: float = 0.015,
                 advect_tracers: bool = True, hord_mt: int = 0,
                 hord_tm: int = 0, chart=None,
                 stag_tabs: Optional[StagResample] = None,
                 vtx_damp: float = 0.0) -> SubstepOut:
    """One forward-backward acoustic substep on padded fields;
    nonhydrostatic when s carries delz (pz_x).

    chart: optional ChartCorners.  stag_tabs: when given, the damping
    divergence takes the exchange form; None = the in-kernel blend."""
    h, ny, nx = ops.h, ops.ny, ops.nx

    def refill(a):
        out = ops.fill(a, "x")
        return chart.apply_scalar(out, "x") if chart is not None else out

    islice = (slice(None), slice(h, h + ny), slice(h, h + nx))

    uct, vct, vort_c, ua, va = c_sw(s, m, 0.5 * dt, ptop, chart=chart)
    div_cg = damping_divergence(s.pu, s.pv, ua, va, uct, vct, m, ops,
                                stag_tabs) if stag_tabs is not None else None

    crx = uct * dt * m.rdxc
    cry = vct * dt * m.rdyc
    xfx = uct * dt * m.dy
    yfx = vct * dt * m.dx
    delp_new, pt_new, w_adv, delz_adv, q_new, mf = transport_part(
        s, m, crx, cry, xfx, yfx, hord, advect_tracers, hord_tm=hord_tm)

    # the transport exhausts the inbound halo: refill delp/pt before the
    # backward PGF reads them at the corners
    delp_f = refill(delp_new[islice])
    pt_f = refill(pt_new[islice])
    nonhydro = s.pz_x is not None
    if nonhydro:
        # the implicit vertical solve (its kernel on the card: the
        # reference runs this glue on its device in both substep forms),
        # then the backward nonhydrostatic pressure force from the solved
        # fields
        from ..ops.kernels.dsw import nh_vertical_solve

        w_new, delz_new = nh_vertical_solve(w_adv, delz_adv, pt_new,
                                            delp_new, dt, ptop)
        delz_f = refill(delz_new[islice])
        nh_fields = nh_perturbation_fields(delp_f, pt_f, delz_f, ptop)
    else:
        w_new = delz_new = delz_f = nh_fields = None
    pkz, phi_mid = _hydrostatic_fields(delp_f, pt_f, ptop)

    u_new, v_new = wind_part(s, m, uct, vct, crx, cry, pt_f, pkz,
                             phi_mid + m.phis, nh_fields, dt, hord, d2_bg,
                             hord_mt=hord_mt,
                             vort=vort_c if chart is not None else None,
                             div_c_in=div_cg, vtx_damp=vtx_damp)
    return SubstepOut(
        u=u_new[:, h:h + ny + 1, h:h + nx],
        v=v_new[:, h:h + ny, h:h + nx + 1],
        delp=delp_new[islice],
        pt=pt_new[islice],
        q=None if q_new is None else q_new[islice],
        w=None if w_new is None else w_new[islice],
        delz=None if delz_new is None else delz_new[islice],
        mfx=mf.fx[:, h:h + ny, h:h + nx + 1],
        mfy=mf.fy[:, h:h + ny + 1, h:h + nx],
        uc=uct[:, h:h + ny, h:h + nx + 1],
        vc=vct[:, h:h + ny + 1, h:h + nx],
        uct_pad=uct, vct_pad=vct, mfx_pad=mf.fx, mfy_pad=mf.fy,
        pd_fill=delp_f, pt_fill=pt_f, pz_fill=delz_f,
    )

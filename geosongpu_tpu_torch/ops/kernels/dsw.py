"""The fused substep kernels as hand-written CUDA (csrc/dsw_*.cu).

Counterparts of the Pallas call sites of geosongpu_tpu/dycore/
sw_pallas.py: dsw_csw1, dsw_csw2, dsw_transport (hydrostatic, and
nonhydrostatic with w and delz), dsw_tracer and dsw_wind
(d_sw_substep_pallas k1-k4 and k3b; dsw_wind with either damping form and
with the nonhydrostatic PGF terms), dsw_nh_pert (_nh_pert_kernel, the
column stage the nonhydrostatic dsw_wind runs first) and dsw_tracer_acc
(tracer_interval_advect_pallas); and two kernels of the reference's XLA
glue, which it runs outside any Pallas kernel: nh_vertical_solve
(csrc/nh_vertical_solve.cu), the nonhydrostatic substep's vertical glue
between dsw_transport and dsw_wind (sw_pallas.py:618-630: the lax.scan
pair of dycore/nh_solver.py), and agrid_winds (csrc/dsw_agrid.cu), the
A-grid winds before dsw_csw1 (sw_pallas.py:475-479: dycore/sw.py
a_grid_winds).  For each: the wrapper, its `launches` counter and its
plain PyTorch version `<name>_plain`, which has the wrapper's signature and
composes the port's dycore/sw.py functions.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
checks device, dtype, shape and contiguity of every input (the 36
PaddedMetrics fields included, each [F, Ny|Ny+1, Nx|Nx+1, 1]), allocates
outputs and scratch with torch.empty, launches the kernel's C entry on
the current stream and raises on a nonzero CUDA error; `launches` grows by
one per C entry, whatever its internal stages.  Arrays are [F, Ny, Nx, K]
centres, [F, Ny, Nx+1, K] x-interfaces, [F, Ny+1, Nx, K] y-interfaces and
[F, Ny+1, Nx+1, K] corners; F, Ny, Nx and K come from the inputs.
nh_vertical_solve checks its inputs on either device, so that the CPU
tests hold its checks too.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.grid import CP_AIR, GRAV, KAPPA, RDGAS
from ...dycore.nh_solver import GAMMA
from ...dycore.sw import (P00, PaddedMetrics, SWState, _hydrostatic_fields,
                          a_grid_winds, c_sw_part1, c_sw_part2,
                          nh_perturbation_fields, nh_vertical_glue,
                          transport_part, wind_part)
from ...spans import spanned
from ..fvtp2d import ddx, ddy, fvtp2d
from .build import check_tensors as _check
from .build import device_of as _device
from .build import launch, load_library

# (rows - Ny, cols - Nx) of each PaddedMetrics field, in field order
METRIC_STAGGER = {
    "area": (0, 0), "rarea": (0, 0), "dx": (1, 0), "dy": (0, 1),
    "dxc": (0, 1), "dyc": (1, 0), "fcor": (0, 0), "rarea_c": (1, 1),
    "cosa_i": (0, 1), "rsina_i": (0, 1), "cosa_j": (1, 0),
    "rsina_j": (1, 0), "rdx": (1, 0), "rdy": (0, 1), "rdxc": (0, 1),
    "rdyc": (1, 0), "cosa_c": (0, 0), "rsin2_c": (0, 0), "cosa_cn": (1, 1),
    "rsin2_cn": (1, 1), "phis": (0, 0), "dw00": (1, 1), "dw01": (1, 1),
    "dw10": (1, 1), "dw11": (1, 1), "dr11": (0, 0), "r12": (0, 0),
    "r21": (0, 0), "dr22": (0, 0), "jwm": (0, 0), "jwp": (0, 0),
    "iwm": (0, 0), "iwp": (0, 0), "rdxc_c": (0, 1), "rdyc_c": (1, 0),
    "div_blend": (1, 1),
}
assert tuple(METRIC_STAGGER) == PaddedMetrics._fields
_NM = len(METRIC_STAGGER)


class _MetricsC(ctypes.Structure):
    """struct Metrics of csrc/dsw_common.cuh."""

    _fields_ = [("p", ctypes.c_void_p * _NM), ("rows", ctypes.c_int * _NM),
                ("cols", ctypes.c_int * _NM)]


_METRIC_CACHE = {}      # id(m) -> (m, (F, Ny, Nx, device), _MetricsC)
_NAMES_CHECKED = False


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def courant(u, v, m: PaddedMetrics, dt: float):
    """Courant numbers and area fluxes from advective winds
    (sw_pallas.py:548-550): (crx, cry, xfx, yfx)."""
    return u * dt * m.rdxc, v * dt * m.rdyc, u * dt * m.dy, v * dt * m.dx


# -> (ua, va): the average to cell centres, the halo basis rotation and
# the chart resample in y then x
agrid_winds_plain = a_grid_winds


def dsw_csw1_plain(pu, pv, ua, va, pd_x, pd_y, pt_x, pt_y,
                   m: PaddedMetrics, dt2: float):
    """-> (uc, vc, delp_h, pt_h, ke, vort)."""
    s = SWState(pu=pu, pv=pv, pd_x=pd_x, pd_y=pd_y, pt_x=pt_x, pt_y=pt_y)
    return c_sw_part1(s, m, dt2, ua, va)


def dsw_csw2_plain(uc, vc, delp_h, pt_h, ke, vort, m: PaddedMetrics,
                   ptop: float, dt2: float):
    """-> (uct, vct)."""
    pkz, phi = _hydrostatic_fields(delp_h, pt_h, ptop)
    return c_sw_part2(uc, vc, pt_h, pkz, phi + m.phis, ke, vort, m, dt2)


def dsw_transport_plain(pd_x, pd_y, pt_x, pt_y, uct, vct, m: PaddedMetrics,
                        dt: float, hord: int, nh=None):
    """-> (delp_new, pt_new, mfx, mfy), all padded; with nh = (pw_x, pw_y,
    pz_x, pz_y) also (w_adv, delz_adv)."""
    crx, cry, xfx, yfx = courant(uct, vct, m, dt)
    pw_x, pw_y, pz_x, pz_y = nh if nh is not None else (None,) * 4
    s = SWState(pu=None, pv=None, pd_x=pd_x, pd_y=pd_y, pt_x=pt_x, pt_y=pt_y,
                pw_x=pw_x, pw_y=pw_y, pz_x=pz_x, pz_y=pz_y)
    delp_new, pt_new, w_adv, delz_adv, _, mf = transport_part(
        s, m, crx, cry, xfx, yfx, hord, False)
    outs = (delp_new, pt_new, mf.fx, mf.fy)
    return outs + (w_adv, delz_adv) if nh is not None else outs


def dsw_tracer_plain(qx, qy, pd_x, delp_new, uct, vct, mfx, mfy,
                     m: PaddedMetrics, dt: float, hord: int):
    """One tracer of one substep with the substep's mass fluxes
    (sw_pallas.py k3b, :587-593) -> (q_new,), padded."""
    crx, cry, xfx, yfx = courant(uct, vct, m, dt)
    qf = fvtp2d(qx, qy, crx, cry, xfx, yfx, m.area, hord=hord, mfx=mfx,
                mfy=mfy)
    return ((qx * pd_x + (ddx(qf.fx) + ddy(qf.fy)) * m.rarea) / delp_new,)


def dsw_nh_pert_plain(delp_f, pt_f, delz_f, ptop: float):
    """-> (pprime, phiprime, rho1) of the solved nonhydrostatic state."""
    return nh_perturbation_fields(delp_f, pt_f, delz_f, ptop)


def nh_vertical_solve_plain(w_adv, delz_adv, pt_new, delp_new, dt: float,
                            ptop: float):
    """-> padded (w_new, delz_new): interface w, the implicit vertical
    acoustic solve, delz clamped at 1 m, layer w."""
    return nh_vertical_glue(w_adv, delz_adv, pt_new, delp_new, dt, ptop)


def dsw_wind_plain(pu, pv, uct, vct, delp_f, pt_f, vort, div_c,
                   m: PaddedMetrics, ptop: float, dt: float, hord_mt: int,
                   d2_bg: float, vtx_damp: float = 0.0, delz_f=None):
    """-> padded (u_new, v_new).  div_c=None: the blend damping form;
    delz_f: the refilled delz of the nonhydrostatic substep."""
    pkz, phi = _hydrostatic_fields(delp_f, pt_f, ptop)
    nh = None if delz_f is None else dsw_nh_pert_plain(delp_f, pt_f, delz_f,
                                                       ptop)
    crx, cry, _, _ = courant(uct, vct, m, dt)
    s = SWState(pu=pu, pv=pv, pd_x=None, pd_y=None, pt_x=None, pt_y=None)
    return wind_part(s, m, uct, vct, crx, cry, pt_f, pkz, phi + m.phis, nh,
                     dt, hord_mt, d2_bg, hord_mt=hord_mt, vort=vort,
                     div_c_in=div_c, vtx_damp=vtx_damp)


def dsw_tracer_acc_plain(qx, qy, pd_x, uacc, vacc, mfx, mfy,
                         m: PaddedMetrics, dt: float, hord: int):
    """One z_tracer subcycle of one tracer (sw_pallas.py:399-410)
    -> padded (delp_new, q_new)."""
    crx, cry, xfx, yfx = courant(uacc, vacc, m, dt)
    delp_new = pd_x + (ddx(mfx) + ddy(mfy)) * m.rarea
    qf = fvtp2d(qx, qy, crx, cry, xfx, yfx, m.area, hord=hord, mfx=mfx,
                mfy=mfy)
    qdp = qx * pd_x + (ddx(qf.fx) + ddy(qf.fy)) * m.rarea
    return delp_new, qdp / delp_new


# --------------------------------------------------------------------------
# checks and launch
# --------------------------------------------------------------------------

def _grid(name: str, t):
    if t.dim() != 4:
        raise ValueError(f"{name} must be [F, Ny, Nx, K], got shape "
                         f"{tuple(t.shape)}")
    return tuple(t.shape)


def _metrics(kernel: str, m: PaddedMetrics, F, Ny, Nx, dev) -> _MetricsC:
    """The checked C struct of m's pointers and extents (cached per m)."""
    key = (F, Ny, Nx, dev)
    hit = _METRIC_CACHE.get(id(m))
    if hit is not None and hit[0] is m and hit[1] == key:
        return hit[2]
    if not isinstance(m, PaddedMetrics):
        raise TypeError(f"{kernel}: metrics must be a PaddedMetrics")
    s = _MetricsC()
    for n, (name, (sy, sx)) in enumerate(METRIC_STAGGER.items()):
        t = getattr(m, name)
        _check(kernel, dev, [(f"metrics.{name}", t,
                              (F, Ny + sy, Nx + sx, 1))])
        s.p[n], s.rows[n], s.cols[n] = t.data_ptr(), Ny + sy, Nx + sx
    if len(_METRIC_CACHE) > 8:
        _METRIC_CACHE.clear()
    _METRIC_CACHE[id(m)] = (m, key, s)
    return s


def _launch(kernel: str, spec: str, dev, args):
    """build.launch, after one check of the library's metric order."""
    global _NAMES_CHECKED
    if not _NAMES_CHECKED:
        names = load_library().function("dsw_metric_names", [],
                                        ctypes.c_char_p)()
        if tuple(names.decode().split(",")) != PaddedMetrics._fields:
            raise RuntimeError("csrc/dsw_common.cuh's metric order differs "
                               "from PaddedMetrics._fields")
        _NAMES_CHECKED = True
    launch(kernel, spec, dev, args)


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _hord(kernel: str, hord: int):
    if hord not in (6, 8):
        raise ValueError(f"{kernel}: hord must be 6 or 8, got {hord}")


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

@spanned("kernel.agrid_winds")
def agrid_winds(pu, pv, m: PaddedMetrics):
    """The A-grid winds of the padded D-grid winds pu [F, Ny+1, Nx, K] and
    pv [F, Ny, Nx+1, K] in one launch (sw_pallas.py:475-479, the glue
    before k1) -> (ua, va), each [F, Ny, Nx, K]."""
    dev = _device("agrid_winds: pu", pu)
    if dev.type == "cpu":
        return agrid_winds_plain(pu, pv, m)
    F, Ny, Nx, K = _grid("agrid_winds: pu", pu)
    Ny -= 1
    c = (F, Ny, Nx, K)
    _check("agrid_winds", dev, [("pu", pu, (F, Ny + 1, Nx, K)),
                                ("pv", pv, (F, Ny, Nx + 1, K))])
    ms = _metrics("agrid_winds", m, F, Ny, Nx, dev)
    ua, va = (torch.empty(c, dtype=torch.float32, device=dev)
              for _ in range(2))
    _launch("agrid_winds", "Piiii" + "PPPP", dev,
            [ctypes.addressof(ms), F, Ny, Nx, K, *_ptrs(pu, pv, ua, va)])
    agrid_winds.launches += 1
    return ua, va


@spanned("kernel.dsw_csw1")
def dsw_csw1(pu, pv, ua, va, pd_x, pd_y, pt_x, pt_y, m: PaddedMetrics,
             dt2: float):
    """C-grid winds, half-step delp/pt, centre KE and absolute vorticity
    (sw_pallas.py k1) -> (uc, vc, delp_h, pt_h, ke, vort)."""
    dev = _device("dsw_csw1: ua", ua)
    if dev.type == "cpu":
        return dsw_csw1_plain(pu, pv, ua, va, pd_x, pd_y, pt_x, pt_y, m, dt2)
    F, Ny, Nx, K = _grid("dsw_csw1: ua", ua)
    c, xi, yi = (F, Ny, Nx, K), (F, Ny, Nx + 1, K), (F, Ny + 1, Nx, K)
    _check("dsw_csw1", dev, [("pu", pu, yi), ("pv", pv, xi), ("ua", ua, c),
                             ("va", va, c), ("pd_x", pd_x, c),
                             ("pd_y", pd_y, c), ("pt_x", pt_x, c),
                             ("pt_y", pt_y, c)])
    ms = _metrics("dsw_csw1", m, F, Ny, Nx, dev)
    e = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    outs = (e(xi), e(yi), e(c), e(c), e(c), e(c))
    _launch("dsw_csw1", "Piiii" + "P" * 8 + "f" + "P" * 6, dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(pu, pv, ua, va, pd_x, pd_y, pt_x, pt_y), dt2,
             *_ptrs(*outs)])
    dsw_csw1.launches += 1
    return outs


@spanned("kernel.dsw_csw2")
def dsw_csw2(uc, vc, delp_h, pt_h, ke, vort, m: PaddedMetrics, ptop: float,
             dt2: float):
    """Column integral of the half state, chart resample and time-centred
    C-grid winds (sw_pallas.py k2) -> (uct, vct)."""
    dev = _device("dsw_csw2: delp_h", delp_h)
    if dev.type == "cpu":
        return dsw_csw2_plain(uc, vc, delp_h, pt_h, ke, vort, m, ptop, dt2)
    F, Ny, Nx, K = _grid("dsw_csw2: delp_h", delp_h)
    c, xi, yi = (F, Ny, Nx, K), (F, Ny, Nx + 1, K), (F, Ny + 1, Nx, K)
    _check("dsw_csw2", dev, [("uc", uc, xi), ("vc", vc, yi),
                             ("delp_h", delp_h, c), ("pt_h", pt_h, c),
                             ("ke", ke, c), ("vort", vort, c)])
    ms = _metrics("dsw_csw2", m, F, Ny, Nx, dev)
    e = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    pkz, phi, uct, vct = e(c), e(c), e(xi), e(yi)
    _launch("dsw_csw2", "Piiii" + "P" * 6 + "fffff" + "PPPP", dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(uc, vc, delp_h, pt_h, ke, vort), ptop, P00, KAPPA,
             CP_AIR, dt2, *_ptrs(pkz, phi, uct, vct)])
    dsw_csw2.launches += 1
    return uct, vct


@spanned("kernel.dsw_transport")
def dsw_transport(pd_x, pd_y, pt_x, pt_y, uct, vct, m: PaddedMetrics,
                  dt: float, hord: int, nh=None):
    """PPM transport of delp and pt (sw_pallas.py k3)
    -> padded (delp_new, pt_new, mfx, mfy).  nh: the nonhydrostatic
    fills (pw_x, pw_y, pz_x, pz_y); w is then transported mass-weighted
    like pt and delz in volume form like delp, clamped at 1 m, and the
    result gains (w_adv, delz_adv)."""
    dev = _device("dsw_transport: pd_x", pd_x)
    if dev.type == "cpu":
        return dsw_transport_plain(pd_x, pd_y, pt_x, pt_y, uct, vct, m, dt,
                                   hord, nh)
    _hord("dsw_transport", hord)
    F, Ny, Nx, K = _grid("dsw_transport: pd_x", pd_x)
    c, xi, yi = (F, Ny, Nx, K), (F, Ny, Nx + 1, K), (F, Ny + 1, Nx, K)
    named = [("pd_x", pd_x, c), ("pd_y", pd_y, c), ("pt_x", pt_x, c),
             ("pt_y", pt_y, c), ("uct", uct, xi), ("vct", vct, yi)]
    if nh is not None:
        named += list(zip(("pw_x", "pw_y", "pz_x", "pz_y"), nh, (c,) * 4))
    _check("dsw_transport", dev, named)
    ms = _metrics("dsw_transport", m, F, Ny, Nx, dev)
    e = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = (e(xi), e(yi))
    outs = (e(c), e(c), e(xi), e(yi))
    # the nonhydrostatic pass reuses the scratch of the first; delz needs
    # its own pair of flux arrays
    nh_ptrs = [None] * 8
    if nh is not None:
        nh_out = (e(xi), e(yi), e(c), e(c))
        nh_ptrs = _ptrs(*nh, *nh_out)
        outs = outs + nh_out[2:]
    _launch("dsw_transport", "Piiii" + "P" * 6 + "fi" + "P" * 14, dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(pd_x, pd_y, pt_x, pt_y, uct, vct), dt, hord,
             *_ptrs(*scratch, *outs[:4]), *nh_ptrs])
    dsw_transport.launches += 1
    return outs


@spanned("kernel.dsw_tracer")
def dsw_tracer(qx, qy, pd_x, delp_new, uct, vct, mfx, mfy, m: PaddedMetrics,
               dt: float, hord: int):
    """One tracer of one substep, advected with the substep's winds and
    mass fluxes and divided by the transported delp (sw_pallas.py k3b)
    -> (q_new,), padded."""
    dev = _device("dsw_tracer: pd_x", pd_x)
    if dev.type == "cpu":
        return dsw_tracer_plain(qx, qy, pd_x, delp_new, uct, vct, mfx, mfy,
                                m, dt, hord)
    _hord("dsw_tracer", hord)
    F, Ny, Nx, K = _grid("dsw_tracer: pd_x", pd_x)
    c, xi, yi = (F, Ny, Nx, K), (F, Ny, Nx + 1, K), (F, Ny + 1, Nx, K)
    _check("dsw_tracer", dev, [("qx", qx, c), ("qy", qy, c),
                               ("pd_x", pd_x, c), ("delp_new", delp_new, c),
                               ("uct", uct, xi), ("vct", vct, yi),
                               ("mfx", mfx, xi), ("mfy", mfy, yi)])
    ms = _metrics("dsw_tracer", m, F, Ny, Nx, dev)
    e = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = (e(xi), e(yi))
    q_new = e(c)
    _launch("dsw_tracer", "Piiii" + "P" * 8 + "fi" + "P" * 3, dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(qx, qy, pd_x, delp_new, uct, vct, mfx, mfy), dt, hord,
             *_ptrs(*scratch, q_new)])
    dsw_tracer.launches += 1
    return (q_new,)


@spanned("kernel.dsw_nh_pert")
def dsw_nh_pert(delp_f, pt_f, delz_f, ptop: float):
    """p', phi' and rho of the solved nonhydrostatic state, by column
    (sw_pallas.py _nh_pert_kernel) -> (pprime, phiprime, rho1)."""
    dev = _device("dsw_nh_pert: delp_f", delp_f)
    if dev.type == "cpu":
        return dsw_nh_pert_plain(delp_f, pt_f, delz_f, ptop)
    F, Ny, Nx, K = c = _grid("dsw_nh_pert: delp_f", delp_f)
    _check("dsw_nh_pert", dev, [("delp_f", delp_f, c), ("pt_f", pt_f, c),
                                ("delz_f", delz_f, c)])
    outs = tuple(torch.empty(c, dtype=torch.float32, device=dev)
                 for _ in range(3))
    _launch("dsw_nh_pert", "iiii" + "PPP" + "fffff" + "PPP", dev,
            [F, Ny, Nx, K, *_ptrs(delp_f, pt_f, delz_f), ptop, P00, KAPPA,
             GRAV, RDGAS, *_ptrs(*outs)])
    dsw_nh_pert.launches += 1
    return outs


@spanned("kernel.nh_vertical_solve")
def nh_vertical_solve(w_adv, delz_adv, pt_new, delp_new, dt: float,
                      ptop: float):
    """The nonhydrostatic substep's vertical glue in one launch: interface
    w of the advected layer w, the implicit acoustic solve (two Newton
    linearisations, Thomas), delz clamped at 1 m, layer w (sw_pallas.py:
    618-630) -> padded (w_new, delz_new).  Every input [F, Ny, Nx, K],
    K >= 2, checked on either device."""
    dev = _device("nh_vertical_solve: w_adv", w_adv)
    F, Ny, Nx, K = c = _grid("nh_vertical_solve: w_adv", w_adv)
    if K < 2:
        raise ValueError(f"nh_vertical_solve: needs K >= 2 levels, got {K}")
    _check("nh_vertical_solve", dev, [("w_adv", w_adv, c),
                                      ("delz_adv", delz_adv, c),
                                      ("pt_new", pt_new, c),
                                      ("delp_new", delp_new, c)])
    if dev.type == "cpu":
        return nh_vertical_solve_plain(w_adv, delz_adv, pt_new, delp_new, dt,
                                       ptop)
    outs = tuple(torch.empty(c, dtype=torch.float32, device=dev)
                 for _ in range(2))
    _launch("nh_vertical_solve", "iiii" + "PPPP" + "f" * 7 + "PP", dev,
            [F, Ny, Nx, K, *_ptrs(w_adv, delz_adv, pt_new, delp_new), dt,
             ptop, P00, KAPPA, GAMMA, GRAV, RDGAS, *_ptrs(*outs)])
    nh_vertical_solve.launches += 1
    return outs


@spanned("kernel.dsw_wind")
def dsw_wind(pu, pv, uct, vct, delp_f, pt_f, vort, div_c, m: PaddedMetrics,
             ptop: float, dt: float, hord_mt: int, d2_bg: float,
             vtx_damp: float = 0.0, delz_f=None):
    """Column integral of the refilled state and the D-grid wind update
    (sw_pallas.py k4) -> padded (u_new, v_new).  div_c: the exchange-form
    damping divergence [F, Ny+1, Nx+1, K], or None for the blend form: the
    kernel's tile then forms the dual/cell blend from pu, pv, uct and vct
    at each corner.  delz_f: the refilled delz of the nonhydrostatic substep;
    dsw_nh_pert then runs first and the PGF takes its p', phi' and rho."""
    dev = _device("dsw_wind: delp_f", delp_f)
    if dev.type == "cpu":
        return dsw_wind_plain(pu, pv, uct, vct, delp_f, pt_f, vort, div_c, m,
                              ptop, dt, hord_mt, d2_bg, vtx_damp, delz_f)
    _hord("dsw_wind", hord_mt)
    F, Ny, Nx, K = _grid("dsw_wind: delp_f", delp_f)
    c, xi, yi = (F, Ny, Nx, K), (F, Ny, Nx + 1, K), (F, Ny + 1, Nx, K)
    cn = (F, Ny + 1, Nx + 1, K)
    named = [("pu", pu, yi), ("pv", pv, xi), ("uct", uct, xi),
             ("vct", vct, yi), ("delp_f", delp_f, c), ("pt_f", pt_f, c),
             ("vort", vort, c)]
    if div_c is not None:
        named.append(("div_c", div_c, cn))
    _check("dsw_wind", dev, named)
    ms = _metrics("dsw_wind", m, F, Ny, Nx, dev)
    e = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    # nh_t stays referenced until the launch below is enqueued
    nh_t = () if delz_f is None else dsw_nh_pert(delp_f, pt_f, delz_f, ptop)
    nh = _ptrs(*nh_t) if nh_t else [None] * 3
    div = None if div_c is None else div_c.data_ptr()
    pkz, phi, u_new, v_new = e(c), e(c), e(yi), e(xi)
    _launch("dsw_wind", "Piiii" + "P" * 8 + "PPP" + "ffff" + "fiffi"
            + "PPPP", dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(pu, pv, uct, vct, delp_f, pt_f, vort), div, *nh, ptop,
             P00, KAPPA, CP_AIR, dt, hord_mt, d2_bg / dt, vtx_damp / dt,
             int(vtx_damp > 0.0), *_ptrs(pkz, phi, u_new, v_new)])
    dsw_wind.launches += 1
    return u_new, v_new


@spanned("kernel.dsw_tracer_acc")
def dsw_tracer_acc(qx, qy, pd_x, uacc, vacc, mfx, mfy, m: PaddedMetrics,
                   dt: float, hord: int):
    """One z_tracer subcycle of one tracer (sw_pallas.py:377)
    -> padded (delp_new, q_new)."""
    dev = _device("dsw_tracer_acc: pd_x", pd_x)
    if dev.type == "cpu":
        return dsw_tracer_acc_plain(qx, qy, pd_x, uacc, vacc, mfx, mfy, m,
                                    dt, hord)
    _hord("dsw_tracer_acc", hord)
    F, Ny, Nx, K = _grid("dsw_tracer_acc: pd_x", pd_x)
    c, xi, yi = (F, Ny, Nx, K), (F, Ny, Nx + 1, K), (F, Ny + 1, Nx, K)
    _check("dsw_tracer_acc", dev, [("qx", qx, c), ("qy", qy, c),
                                   ("pd_x", pd_x, c), ("uacc", uacc, xi),
                                   ("vacc", vacc, yi), ("mfx", mfx, xi),
                                   ("mfy", mfy, yi)])
    ms = _metrics("dsw_tracer_acc", m, F, Ny, Nx, dev)
    e = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = (e(xi), e(yi))
    outs = (e(c), e(c))
    _launch("dsw_tracer_acc", "Piiii" + "P" * 7 + "fi" + "P" * 4, dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(qx, qy, pd_x, uacc, vacc, mfx, mfy), dt, hord,
             *_ptrs(*scratch, *outs)])
    dsw_tracer_acc.launches += 1
    return outs


KERNELS = (dsw_csw1, dsw_csw2, dsw_transport, dsw_wind, dsw_tracer_acc,
           dsw_tracer, dsw_nh_pert, nh_vertical_solve, agrid_winds)
for _k in KERNELS:
    _k.launches = 0

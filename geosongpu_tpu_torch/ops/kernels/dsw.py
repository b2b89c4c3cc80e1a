"""The fused substep kernels as hand-written CUDA (csrc/dsw_*.cu).

Counterparts of the Pallas call sites of geosongpu_tpu/dycore/
sw_pallas.py: dsw_csw1, dsw_csw2, dsw_transport (hydrostatic, and
nonhydrostatic with w and delz), dsw_tracer and dsw_wind
(d_sw_substep_pallas k1-k4 and k3b; dsw_wind with either damping form and
with the nonhydrostatic PGF terms), dsw_nh_pert (_nh_pert_kernel, the
column stage the nonhydrostatic dsw_wind runs first) and dsw_tracer_acc
(tracer_interval_advect_pallas).  For each: the wrapper, its `launches`
counter and its plain PyTorch version `<name>_plain`, which has the
wrapper's signature and composes the port's dycore/sw.py functions.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
checks device, dtype, shape and contiguity of every input (the 36
PaddedMetrics fields included, each [F, Ny|Ny+1, Nx|Nx+1, 1]), allocates
outputs and scratch with torch.empty, launches the kernel's C entry on
the current stream and raises on a nonzero CUDA error; `launches` grows by
one per C entry, whatever its internal stages.  Arrays are [F, Ny, Nx, K]
centres, [F, Ny, Nx+1, K] x-interfaces, [F, Ny+1, Nx, K] y-interfaces and
[F, Ny+1, Nx+1, K] corners; F, Ny, Nx and K come from the inputs.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.grid import CP_AIR, GRAV, KAPPA, RDGAS
from ...dycore.sw import (P00, PaddedMetrics, SWState, _hydrostatic_fields,
                          c_sw_part1, c_sw_part2, nh_perturbation_fields,
                          transport_part, wind_part)
from ..fvtp2d import ddx, ddy, fvtp2d
from .build import load_library

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


_CTYPES = {"P": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_METRIC_CACHE = {}      # id(m) -> (m, (F, Ny, Nx, device), _MetricsC)
_NAMES_CHECKED = False


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def courant(u, v, m: PaddedMetrics, dt: float):
    """Courant numbers and area fluxes from advective winds
    (sw_pallas.py:548-550): (crx, cry, xfx, yfx)."""
    return u * dt * m.rdxc, v * dt * m.rdyc, u * dt * m.dy, v * dt * m.dx


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

def _device(name: str, t) -> torch.device:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _grid(name: str, t):
    if t.dim() != 4:
        raise ValueError(f"{name} must be [F, Ny, Nx, K], got shape "
                         f"{tuple(t.shape)}")
    return tuple(t.shape)


def _check(kernel: str, dev, named_shapes):
    for name, t, shape in named_shapes:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {name} is not a tensor")
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"{dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected "
                            "torch.float32")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)},"
                             f" expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


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
    """Call C entry `<kernel>_f32` with `args` (spec: one of P/i/f per
    argument) plus the device index and current stream; raise on a CUDA
    error."""
    global _NAMES_CHECKED
    lib = load_library()
    if not _NAMES_CHECKED:
        names = lib.function("dsw_metric_names", [], ctypes.c_char_p)()
        if tuple(names.decode().split(",")) != PaddedMetrics._fields:
            raise RuntimeError("csrc/dsw_common.cuh's metric order differs "
                               "from PaddedMetrics._fields")
        _NAMES_CHECKED = True
    fn = lib.function(f"{kernel}_f32",
                      [_CTYPES[c] for c in spec + "iP"])
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    rc = fn(*args, index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{rc}")


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _hord(kernel: str, hord: int):
    if hord not in (6, 8):
        raise ValueError(f"{kernel}: hord must be 6 or 8, got {hord}")


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

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
    scratch = torch.empty((7,) + c, dtype=torch.float32, device=dev)
    uct = torch.empty(xi, dtype=torch.float32, device=dev)
    vct = torch.empty(yi, dtype=torch.float32, device=dev)
    _launch("dsw_csw2", "Piiii" + "P" * 6 + "fffff" + "PPP", dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(uc, vc, delp_h, pt_h, ke, vort), ptop, P00, KAPPA,
             CP_AIR, dt2, *_ptrs(scratch, uct, vct)])
    dsw_csw2.launches += 1
    return uct, vct


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
    scratch = (e(c), e(c), e(c), e(c), e(xi), e(yi))
    outs = (e(c), e(c), e(xi), e(yi))
    # the nonhydrostatic pass reuses the scratch of the first; delz needs
    # its own pair of flux arrays
    nh_ptrs = [None] * 8
    if nh is not None:
        nh_out = (e(xi), e(yi), e(c), e(c))
        nh_ptrs = _ptrs(*nh, *nh_out)
        outs = outs + nh_out[2:]
    _launch("dsw_transport", "Piiii" + "P" * 6 + "fi" + "P" * 18, dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(pd_x, pd_y, pt_x, pt_y, uct, vct), dt, hord,
             *_ptrs(*scratch, *outs[:4]), *nh_ptrs])
    dsw_transport.launches += 1
    return outs


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
    scratch = (e(c), e(c), e(xi), e(yi))
    q_new = e(c)
    _launch("dsw_tracer", "Piiii" + "P" * 8 + "fi" + "P" * 5, dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(qx, qy, pd_x, delp_new, uct, vct, mfx, mfy), dt, hord,
             *_ptrs(*scratch, q_new)])
    dsw_tracer.launches += 1
    return (q_new,)


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


def dsw_wind(pu, pv, uct, vct, delp_f, pt_f, vort, div_c, m: PaddedMetrics,
             ptop: float, dt: float, hord_mt: int, d2_bg: float,
             vtx_damp: float = 0.0, delz_f=None):
    """Column integral of the refilled state and the D-grid wind update
    (sw_pallas.py k4) -> padded (u_new, v_new).  div_c: the exchange-form
    damping divergence [F, Ny+1, Nx+1, K], or None for the blend form: a
    stage of the kernel then computes the dual/cell blend from pu, pv,
    uct and vct.  delz_f: the refilled delz of the nonhydrostatic substep;
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
    div = div_c if div_c is not None else e(cn)
    pkz, phi, u_new, v_new = e(c), e(c), e(yi), e(xi)
    _launch("dsw_wind", "Piiii" + "P" * 8 + "i" + "PPP" + "ffff" + "fiffi"
            + "PPPP", dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(pu, pv, uct, vct, delp_f, pt_f, vort, div),
             int(div_c is None), *nh, ptop, P00, KAPPA, CP_AIR, dt, hord_mt,
             d2_bg / dt, vtx_damp / dt, int(vtx_damp > 0.0),
             *_ptrs(pkz, phi, u_new, v_new)])
    dsw_wind.launches += 1
    return u_new, v_new


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
    scratch = (e(c), e(c), e(xi), e(yi))
    outs = (e(c), e(c))
    _launch("dsw_tracer_acc", "Piiii" + "P" * 7 + "fi" + "P" * 6, dev,
            [ctypes.addressof(ms), F, Ny, Nx, K,
             *_ptrs(qx, qy, pd_x, uacc, vacc, mfx, mfy), dt, hord,
             *_ptrs(*scratch, *outs)])
    dsw_tracer_acc.launches += 1
    return outs


KERNELS = (dsw_csw1, dsw_csw2, dsw_transport, dsw_wind, dsw_tracer_acc,
           dsw_tracer, dsw_nh_pert)
for _k in KERNELS:
    _k.launches = 0

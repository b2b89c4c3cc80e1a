"""The fused substep (geosongpu_tpu/dycore/sw_pallas.py).

`d_sw_substep_fused` runs one acoustic substep as the JAX package's
d_sw_substep_pallas does (sw_pallas.py:432-723), with its face kernels as
the CUDA kernels of ops/kernels/dsw.py and the glue between them in
PyTorch:

1. A-grid winds and the chart reconstruction of their corners;
2. dsw_csw1 (C-grid winds, half-step delp/pt, KE, vorticity);
3. the one-sided chart resample of the vorticity;
4. dsw_csw2 (column integral of the half state folded in, uct/vct);
5. the exchange-form damping divergence (stag_tabs given; with
   stag_tabs=None dsw_wind computes the blend form itself);
6. dsw_transport (delp, pt, mass fluxes; nonhydrostatic: w and delz too);
7. dsw_tracer once per tracer (advect_tracers, the per-substep tracers);
8. refill of delp/pt (halo fill + chart correction);
9. nonhydrostatic: the implicit vertical solve and the refill of delz;
10. dsw_wind (column integrals of the refilled state folded in, with
    dsw_nh_pert first in nonhydrostatic mode; u/v).

`tracer_interval_advect` is tracer_interval_advect_pallas: one z_tracer
subcycle, one dsw_tracer_acc call per tracer.  On CPU tensors every kernel
call runs its plain version.  The TPU-only machinery of the JAX module
(J-tiling, metric packing, the lane cumsum) has no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.kernels import dsw
from ..parallel.halo import HaloOps
from .sw import (PaddedMetrics, StagResample, SubstepOut, SWState,
                 a_grid_winds, damping_divergence, nh_vertical_glue)


def d_sw_substep_fused(s: SWState, m: PaddedMetrics, ops: HaloOps,
                       dt: float, ptop: float, hord: int = 8,
                       d2_bg: float = 0.015, advect_tracers: bool = True,
                       hord_mt: int = 0, hord_tm: int = 0, chart=None,
                       stag_tabs: Optional[StagResample] = None,
                       vtx_damp: float = 0.0) -> SubstepOut:
    """One substep through the fused kernels; the arguments are those of
    sw.d_sw_substep."""
    return _substep(s, m, ops, dt, ptop, hord, d2_bg, advect_tracers,
                    hord_mt, hord_tm, chart, stag_tabs, vtx_damp,
                    lambda name, *args: getattr(dsw, name)(*args))


def substep_kernel_args(s: SWState, m: PaddedMetrics, ops: HaloOps,
                        dt: float, ptop: float, hord: int = 8,
                        d2_bg: float = 0.015, advect_tracers: bool = True,
                        hord_mt: int = 0, hord_tm: int = 0, chart=None,
                        stag_tabs: Optional[StagResample] = None,
                        vtx_damp: float = 0.0):
    """{kernel name: argument tuple} of the substep kernels, as one
    substep from s passes them, with every kernel replaced by its plain
    version: the inputs a kernel check feeds a kernel and its plain
    version (dsw_tracer: those of the last tracer; dsw_nh_pert: the
    column arguments of the nonhydrostatic dsw_wind).
    Returns (args, SubstepOut)."""
    args = {}

    def record(name, *a):
        args[name] = a
        return getattr(dsw, name + "_plain")(*a)

    out = _substep(s, m, ops, dt, ptop, hord, d2_bg, advect_tracers,
                   hord_mt, hord_tm, chart, stag_tabs, vtx_damp, record)
    if s.pz_x is not None:
        w = args["dsw_wind"]
        args["dsw_nh_pert"] = (w[4], w[5], w[14], ptop)
    return args, out


def _substep(s, m, ops, dt, ptop, hord, d2_bg, advect_tracers, hord_mt,
             hord_tm, chart, stag_tabs, vtx_damp, call) -> SubstepOut:
    """The substep with call(kernel name, *args) for each kernel."""
    h, ny, nx = ops.h, ops.ny, ops.nx
    islice = (slice(None), slice(h, h + ny), slice(h, h + nx))
    nonhydro = s.pz_x is not None

    ua, va = a_grid_winds(s.pu, s.pv, m)
    if chart is not None:
        ua, va = chart.apply_agrid(ua, va, s.pu, s.pv)
    uc, vc, delp_h, pt_h, ke, vort = call(
        "dsw_csw1", s.pu, s.pv, ua, va, s.pd_x, s.pd_y, s.pt_x, s.pt_y, m,
        0.5 * dt)
    if chart is not None:
        vort = chart.apply_scalar(vort, "derived")
    uct, vct = call("dsw_csw2", uc, vc, delp_h, pt_h, ke, vort, m, ptop,
                    0.5 * dt)
    div_c = damping_divergence(s.pu, s.pv, ua, va, uct, vct, m, ops,
                               stag_tabs) if stag_tabs is not None else None

    nh_in = (s.pw_x, s.pw_y, s.pz_x, s.pz_y) if nonhydro else None
    outs = call("dsw_transport", s.pd_x, s.pd_y, s.pt_x, s.pt_y, uct, vct,
                m, dt, hord_tm or hord, nh_in)
    delp_new, pt_new, mfx, mfy = outs[:4]

    if s.pq_x is not None and advect_tracers:
        qs = []
        for t in range(s.pq_x.shape[-1]):
            qx = s.pq_x[..., t].contiguous()
            qy = qx if s.pq_y is s.pq_x else s.pq_y[..., t].contiguous()
            qs.append(call("dsw_tracer", qx, qy, s.pd_x, delp_new, uct, vct,
                           mfx, mfy, m, dt, hord)[0])
        q_new = torch.stack(qs, dim=-1)
    else:
        q_new = None

    def refill(a):
        out = ops.fill(a, "x")
        return chart.apply_scalar(out, "x") if chart is not None else out

    delp_f = refill(delp_new[islice])
    pt_f = refill(pt_new[islice])
    if nonhydro:
        w_new, delz_new = nh_vertical_glue(outs[4], outs[5], pt_new,
                                           delp_new, dt, ptop)
        delz_f = refill(delz_new[islice])
    else:
        w_new = delz_new = delz_f = None
    # without a chart the JAX kernel recomputes _vorticity_abs(pu, pv)
    # inside k4: the same function of the same inputs as dsw_csw1's vort
    u_new, v_new = call("dsw_wind", s.pu, s.pv, uct, vct, delp_f, pt_f,
                        vort, div_c, m, ptop, dt, hord_mt or hord, d2_bg,
                        vtx_damp, delz_f)
    return SubstepOut(
        u=u_new[:, h:h + ny + 1, h:h + nx],
        v=v_new[:, h:h + ny, h:h + nx + 1],
        delp=delp_new[islice],
        pt=pt_new[islice],
        q=None if q_new is None else q_new[islice],
        w=None if w_new is None else w_new[islice],
        delz=None if delz_new is None else delz_new[islice],
        mfx=mfx[:, h:h + ny, h:h + nx + 1],
        mfy=mfy[:, h:h + ny + 1, h:h + nx],
        uc=uct[:, h:h + ny, h:h + nx + 1],
        vc=vct[:, h:h + ny + 1, h:h + nx],
        uct_pad=uct, vct_pad=vct, mfx_pad=mfx, mfy_pad=mfy,
        pd_fill=delp_f, pt_fill=pt_f, pz_fill=delz_f,
    )


def tracer_interval_advect(qxs, qys, pd_x, uacc, vacc, dt: float, mfx, mfy,
                           m: PaddedMetrics, hord: int):
    """One z_tracer subcycle of every tracer: the interval delp update and
    fvtp2d of each tracer with the accumulated winds and mass fluxes.
    Returns (delp_new_padded, [q_new_padded per tracer])."""
    dnew, q_new = None, []
    for qx, qy in zip(qxs, qys):
        dnew, qn = dsw.dsw_tracer_acc(qx, qy, pd_x, uacc, vacc, mfx, mfy, m,
                                      dt, hord)
        q_new.append(qn)
    return dnew, q_new

"""Frozen copy of geosongpu_tpu_torch/dycore/fv_dynamics.py at commit
f902e7ad95fb; the fused substep, the CUDA remap and the fused tracer path
taken out; the remap is the plain banded formula.

Full FV dynamics step (geosongpu_tpu/dycore/fv_dynamics.py).

Per model step: k_split x [n_split acoustic substeps -> accumulated-flux
tracer transport (z_tracer) -> vertical remap], then the w sponge and the
diagnostics.  Hydrostatic, or nonhydrostatic with w and delz prognosed
(hydrostatic=False); tracers once per remap interval (z_tracer) or every
substep; either damping form.  The reference's lax.scan over substeps is a
Python loop here.

The substep is the eager sw.d_sw_substep, the z_tracer subcycles are
plain PyTorch, and with remap_band > 0 the vertical remap is the plain
banded formula (ops/remap.py); remap_band == 0 runs the full overlap form.

overlap_fills pipelines the scalar fills: each substep's padded delp/pt
(/delz) are the previous substep's mid-step refills, and only the winds,
w and per-substep tracers are exchanged afresh, which saves exchanges on
a sharded step (parallel/subtile.py).  rim_split is accepted and runs the
unsplit c_sw: the split only lets an asynchronous D-grid exchange overlap
the c_sw core, and the port's rank groups exchange synchronously.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.chart_corners import ChartCorners, build_chart_tables
from ..core.config import DycoreConfig
from ..core.grid import Grid
from ..core.state import DycoreState
from ..device import to_torch
from ..ops.fvtp2d import ddx, ddy, fvtp2d
from ..ops.remap import remap_field, remap_fields_banded
from ..ops.vertical import cumsum_k, interfaces_from_delp
from ..parallel.halo import HaloOps, build_halo_ops
from .nh_solver import _exner_mid, hydrostatic_delz
from .sw import (PaddedMetrics, StagResample, SWState, d_sw_substep,
                 fill_substep, padded_metrics, stag_resample_tables)


def check_supported(cfg: DycoreConfig) -> None:
    """Raise NotImplementedError for the options this port does not run,
    naming the ROADMAP item they belong to."""
    unported = []
    # pallas_jt (J-tiling) is ignored: the JAX package's tiled kernels are
    # bit-identical to whole faces (tests/test_pallas_dycore.py:125-150)
    if cfg.pallas_kt:
        unported.append(f"pallas_kt={cfg.pallas_kt} (TPU vertical tiling, "
                        "which changes the column fold of dsw_csw2 and "
                        "dsw_wind; TPU-only machinery per the ROADMAP)")
    if cfg.dtype != "float32":
        unported.append(f"dtype={cfg.dtype!r} (the port runs float32)")
    # the remap and PPM refuse these values too (ops/remap.py, ops/ppm.py);
    # naming them here makes the model fail when it is built
    if cfg.kord != 8:
        unported.append(f"kord={cfg.kord} (the port's remap is the monotone "
                        "kord 8 form)")
    for name in ("hord", "hord_tm", "hord_mt"):
        value = getattr(cfg, name)
        if value not in (6, 8) and not (value == 0 and name != "hord"):
            unported.append(f"{name}={value} (the port's PPM has the hord 6 "
                            "and 8 forms" + ("" if name == "hord" else
                                             "; 0 follows hord") + ")")
    if unported:
        raise NotImplementedError("not ported: " + "; ".join(unported))


def exner_mid(delp: torch.Tensor, ptop: float) -> torch.Tensor:
    """Layer-mean Exner function pkz (T = pt * pkz)."""
    return _exner_mid(interfaces_from_delp(delp, ptop))


def _use_exchange(cfg: DycoreConfig) -> bool:
    return cfg.damping_exchange == "exchange" or (
        cfg.damping_exchange == "auto" and cfg.npx <= 96)


@dataclass(frozen=True)
class DycoreContext:
    """Static data for the dynamics, on one device."""

    ops: HaloOps
    metrics: PaddedMetrics
    ak: torch.Tensor   # [K+1]
    bk: torch.Tensor
    config: DycoreConfig
    chart: ChartCorners = None
    stag: StagResample = None

    @property
    def device(self) -> torch.device:
        return self.ak.device


def build_context(config: DycoreConfig, grid: Grid, ak: np.ndarray,
                  bk: np.ndarray, device, phis=None) -> DycoreContext:
    """Static data on `device`.  phis: the unpadded [6, n, n] surface
    geopotential (terrain in the PGF of both regimes); None: flat.  Raises
    NotImplementedError for an option the port does not run."""
    check_supported(config)
    chart = None
    if config.chart_corners:
        chart = ChartCorners.from_tables(
            build_chart_tables(config.npx, config.halo), device)
    return DycoreContext(
        ops=build_halo_ops(config.npx, config.halo, device),
        metrics=padded_metrics(grid, device, phis=phis,
                               chart_cosa=config.chart_corners),
        ak=to_torch(ak, device),
        bk=to_torch(bk, device),
        config=config,
        chart=chart,
        stag=stag_resample_tables(grid, device),
    )


def _make_remap(cfg: DycoreConfig, device):
    """Pick the remap: (remap_one, remap_many).

    remap_band > 0: the plain banded formula (ops/remap.py
    remap_fields_banded, four fields a group as the program's kernel
    groups them); remap_band == 0: the full form everywhere."""
    if cfg.remap_band > 0:

        def many(qs, pe1, pe2):
            qs = [q.contiguous() for q in qs]
            return [o for n in range(0, len(qs), 4)
                    for o in remap_fields_banded(qs[n:n + 4], pe1, pe2,
                                                 cfg.kord, cfg.remap_band)]

        return (lambda q, pe1, pe2: many([q], pe1, pe2)[0]), many
    one = lambda q, pe1, pe2: remap_field(q, pe1, pe2, cfg.kord)
    return one, lambda qs, pe1, pe2: [one(q, pe1, pe2) for q in qs]


def _remap_winds(u, v, delp_padded, ak, bk, ptop, h, ny, nx, rm):
    """Remap D-grid winds on their own staggered columns."""
    dpu = 0.5 * (delp_padded[:, h - 1:h + ny, h:h + nx]
                 + delp_padded[:, h:h + ny + 1, h:h + nx])
    pe1u = interfaces_from_delp(dpu, ptop)
    pe2u = ak + bk * pe1u[..., -1:]
    u_new = rm(u, pe1u, pe2u)

    dpv = 0.5 * (delp_padded[:, h:h + ny, h - 1:h + nx]
                 + delp_padded[:, h:h + ny, h:h + nx + 1])
    pe1v = interfaces_from_delp(dpv, ptop)
    pe2v = ak + bk * pe1v[..., -1:]
    v_new = rm(v, pe1v, pe2v)
    return u_new, v_new


def _advect_tracers_accumulated(q, delp0, tacc, ops: HaloOps,
                                m: PaddedMetrics, hord: int, q_split: int,
                                dt: float, chart=None):
    """FV3 z_tracer mode: advect tracers once per remap interval with the
    time-accumulated advective winds and mass fluxes, in q_split
    subcycles.  Preserves q == const to f32 rounding (the PPM edge weights
    7/12 and 1/12 are inexact in f32)."""
    if chart is not None:
        fx = lambda a: chart.apply_scalar(ops.fill(a, "x"), "x")
    else:
        fx = lambda a: ops.fill(a, "x")

    uacc, vacc, mfx, mfy = (a / q_split for a in tacc)
    h, ny, nx = ops.h, ops.ny, ops.nx
    islice = (slice(None), slice(h, h + ny), slice(h, h + nx))
    delp = delp0
    T = q.shape[-1]

    crx = uacc * dt * m.rdxc
    cry = vacc * dt * m.rdyc
    xfx = uacc * dt * m.dy
    yfx = vacc * dt * m.dx
    for _ in range(q_split):
        pd_x = fx(delp)
        delp_new = (pd_x + (ddx(mfx) + ddy(mfy)) * m.rarea)[islice]
        qs = []
        for t in range(T):
            qx = fx(q[..., t])
            qy = qx if chart is not None else ops.fill(q[..., t], "y")
            qf = fvtp2d(qx, qy, crx, cry, xfx, yfx, m.area, hord=hord,
                        mfx=mfx, mfy=mfy)
            qdp = (qx * pd_x + (ddx(qf.fx) + ddy(qf.fy)) * m.rarea)[islice]
            qs.append(qdp / delp_new)
        q = torch.stack(qs, dim=-1)
        delp = delp_new
    return q


def fv_dynamics_step(state: DycoreState, ctx: DycoreContext,
                     remap=None) -> DycoreState:
    """One dynamics step.  remap: (remap_one, remap_many) from _make_remap,
    built here when not given."""
    cfg = ctx.config
    ops, m = ctx.ops, ctx.metrics
    h, ny, nx = cfg.halo, ops.ny, ops.nx
    dt_acoustic = cfg.dt / (cfg.k_split * cfg.n_split)
    rm, rm_many = remap if remap is not None else _make_remap(cfg, ctx.device)

    u, v = state.u, state.v
    delp, pt, q = state.delp, state.pt, state.q
    mfx_acc = torch.zeros_like(state.mfx)
    mfy_acc = torch.zeros_like(state.mfy)
    has_q = q is not None and q.shape[-1] > 0
    if not has_q:
        q = None
    z_tracer = cfg.z_tracer and has_q   # accumulated-flux tracer transport
    substep_tracers = has_q and not z_tracer
    nonhydro = not cfg.hydrostatic
    if nonhydro:
        # arm delz on the first step (init ships zeros): exact discrete
        # hydrostatic balance, so p' == 0 until the dynamics perturbs it
        delz = torch.where(state.delz > 1.0, state.delz,
                           hydrostatic_delz(delp, pt, cfg.ptop))
        w = state.w
    else:
        w = delz = None
    chart = ctx.chart
    stag = ctx.stag if _use_exchange(cfg) else None
    substep = d_sw_substep

    def fx(a):
        if a is None:
            return None
        out = ops.fill(a, "x")
        return chart.apply_scalar(out, "x") if chart is not None else out

    def fy(a, same):
        # under chart corners the corrected x-fill serves both directions
        if a is None:
            return None
        return same if chart is not None else ops.fill(a, "y")

    F = delp.shape[0]
    Ny, Nx, K = ny + 2 * h, nx + 2 * h, cfg.npz
    for _ks in range(cfg.k_split):
        delp0 = delp
        if z_tracer:
            tacc = [ops.zeros((F, Ny, Nx + 1, K)),
                    ops.zeros((F, Ny + 1, Nx, K)),
                    ops.zeros((F, Ny, Nx + 1, K)),
                    ops.zeros((F, Ny + 1, Nx, K))]
        for i in range(cfg.n_split):
            if cfg.overlap_fills and i > 0:
                # the scalar pads of the previous substep's end
                s = SWState(*ops.fill_dgrid(u, v), *pads)
            else:
                s = fill_substep(ops, u, v, delp, pt,
                                 q if substep_tracers else None,
                                 w=w, delz=delz, chart=chart)
            out = substep(
                s, m, ops, dt_acoustic, cfg.ptop, hord=cfg.hord,
                d2_bg=cfg.d2_bg, advect_tracers=substep_tracers,
                hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm, chart=chart,
                stag_tabs=stag, vtx_damp=cfg.vtx_damp)
            u, v, delp, pt = out.u, out.v, out.delp, out.pt
            if nonhydro:
                w, delz = out.w, out.delz
            if substep_tracers:
                q = out.q
            if z_tracer:
                tacc = [a + b for a, b in zip(tacc, (out.uct_pad, out.vct_pad,
                                                     out.mfx_pad,
                                                     out.mfy_pad))]
            else:
                mfx_acc = mfx_acc + out.mfx
                mfy_acc = mfy_acc + out.mfy
            if cfg.overlap_fills:
                # the substep's mid-step refills of delp/pt (/delz) are
                # fx of the new interiors: reuse them; only w and
                # per-substep tracers are exchanged afresh
                qs = q if substep_tracers else None
                pq, pw = fx(qs), fx(w)
                pads = (out.pd_fill, fy(delp, out.pd_fill),
                        out.pt_fill, fy(pt, out.pt_fill), pq, fy(qs, pq),
                        pw, fy(w, pw), out.pz_fill, fy(delz, out.pz_fill))
        if z_tracer:
            mfx_acc = mfx_acc + tacc[2][:, h:h + ny, h:h + nx + 1]
            mfy_acc = mfy_acc + tacc[3][:, h:h + ny + 1, h:h + nx]
            q = _advect_tracers_accumulated(q, delp0, tacc, ops, m, cfg.hord,
                                            cfg.q_split, dt_acoustic,
                                            chart=chart)

        # ---- vertical remap back to the reference hybrid coordinate ----
        pe1 = interfaces_from_delp(delp, cfg.ptop)
        ps = pe1[..., -1]
        pe2 = ctx.ak + ctx.bk * ps[..., None]
        delp_new = pe2[..., 1:] - pe2[..., :-1]
        # pt, tracers (and w / specific volume) share (pe1, pe2): one
        # multi-field call computes the overlap geometry once
        nq = 0 if q is None else q.shape[-1]
        fields = [pt] + [q[..., t] for t in range(nq)]
        if nonhydro:
            # w remaps mass-weighted like any scalar; delz in its
            # per-unit-mass form, so that the column height is conserved
            fields += [w, delz / torch.clamp(delp, min=1e-3)]
        out = rm_many(fields, pe1, pe2)
        pt = out[0]
        if q is not None:
            q = torch.stack(out[1:1 + nq], dim=-1)
        if nonhydro:
            w = out[1 + nq]
            delz = out[2 + nq] * delp_new
        # with overlap_fills the last substep's padded delp is fx(delp)
        dpad = pads[0] if cfg.overlap_fills else ops.fill(delp, "x")
        u, v = _remap_winds(u, v, dpad, ctx.ak, ctx.bk, cfg.ptop, h, ny, nx,
                            rm)
        delp = delp_new

    if nonhydro and cfg.w_sponge_p > 0.0:
        # model-top Rayleigh sponge on w: upward-propagating acoustic and
        # gravity waves are absorbed instead of reflecting off the lid
        pe_s = interfaces_from_delp(delp, cfg.ptop)
        pm_s = 0.5 * (pe_s[..., 1:] + pe_s[..., :-1])
        fac = torch.where(pm_s < cfg.w_sponge_p,
                          float(np.float32(np.exp(-cfg.dt
                                                  / cfg.w_sponge_tau))), 1.0)
        w = w * fac

    # ---- diagnostics ----------------------------------------------------
    pe = interfaces_from_delp(delp, cfg.ptop)
    ps = pe[..., -1]
    ua = 0.5 * (u[:, :-1, :] + u[:, 1:, :])
    va = 0.5 * (v[:, :, :-1] + v[:, :, 1:])
    conv = (((mfx_acc[:, :, :-1] - mfx_acc[:, :, 1:])
             + (mfy_acc[:, :-1, :] - mfy_acc[:, 1:, :]))
            * m.rarea[:, h:h + ny, h:h + nx] / cfg.dt)
    omga = cumsum_k(conv) - 0.5 * conv

    return DycoreState(
        u=u, v=v, delp=delp, pt=pt,
        q=q if has_q else state.q,
        w=w if nonhydro else state.w,
        delz=delz if nonhydro else state.delz, phis=state.phis,
        ps=ps, omga=omga, ua=ua, va=va,
        mfx=mfx_acc, mfy=mfy_acc,
    )

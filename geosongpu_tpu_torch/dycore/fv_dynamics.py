"""Full hydrostatic FV dynamics step (geosongpu_tpu/dycore/fv_dynamics.py).

Per model step: k_split x [n_split acoustic substeps -> accumulated-flux
tracer transport -> vertical remap], then the diagnostics.  The
reference's lax.scan over substeps is a Python loop here.

The vertical remap is the one kernel of this path: with remap_band > 0 a
CUDA tensor goes through the hand-written CUDA kernel
(ops/kernels/remap.py) and a CPU tensor through its plain PyTorch version;
remap_band == 0 runs the full overlap form everywhere.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from geosongpu_tpu.core.chart_corners import build_chart_tables
from geosongpu_tpu.core.config import DycoreConfig
from geosongpu_tpu.core.grid import Grid

from ..core.chart_corners import ChartCorners
from ..core.state import DycoreState
from ..device import to_torch
from ..ops.fvtp2d import ddx, ddy, fvtp2d
from ..ops.kernels.remap import load_library, remap_banded
from ..ops.remap import remap_field
from ..ops.vertical import cumsum_k, interfaces_from_delp
from ..parallel.halo import HaloOps, build_halo_ops
from .sw import (PaddedMetrics, StagResample, d_sw_substep, fill_substep,
                 padded_metrics, stag_resample_tables)


def check_supported(cfg: DycoreConfig) -> None:
    """Raise NotImplementedError for the options this port does not run
    yet, naming the ROADMAP item that will port them."""
    unported = []
    if cfg.pallas_dycore:
        unported.append("pallas_dycore=True (the fused substep kernels: "
                        "ROADMAP queue B items 1-5 and 7)")
    if not cfg.hydrostatic:
        unported.append("hydrostatic=False (ROADMAP queue A item 7)")
    if not cfg.z_tracer and cfg.ntracers > 0:
        unported.append("z_tracer=False (ROADMAP queue A item 8)")
    if cfg.overlap_fills or cfg.rim_split:
        unported.append("overlap_fills / rim_split (ROADMAP queue A item 8)")
    if not _use_exchange(cfg):
        unported.append(f"the blend damping form (damping_exchange="
                        f"{cfg.damping_exchange!r} at npx={cfg.npx}; "
                        "ROADMAP queue A item 8)")
    if cfg.dtype != "float32":
        unported.append(f"dtype={cfg.dtype!r} (the port runs float32)")
    if unported:
        raise NotImplementedError("not ported: " + "; ".join(unported))


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
                  bk: np.ndarray, device) -> DycoreContext:
    """Static data on `device`, for flat terrain.  Raises
    NotImplementedError for an option the port does not run."""
    check_supported(config)
    chart = None
    if config.chart_corners:
        chart = ChartCorners.from_tables(
            build_chart_tables(config.npx, config.halo), device)
    return DycoreContext(
        ops=build_halo_ops(config.npx, config.halo, device),
        metrics=padded_metrics(grid, device, chart_cosa=config.chart_corners),
        ak=to_torch(ak, device),
        bk=to_torch(bk, device),
        config=config,
        chart=chart,
        stag=stag_resample_tables(grid, device),
    )


def _make_remap(cfg: DycoreConfig, device):
    """Pick the remap: (remap_one, remap_many).

    remap_band > 0: the banded kernel wrapper, which launches the CUDA
    kernel for CUDA tensors (the library is built and loaded here, so a
    card without a working build fails now) and runs the plain banded
    version for CPU tensors.  remap_band == 0: the full form everywhere."""
    device = torch.device(device)
    if cfg.remap_band > 0:
        if device.type == "cuda":
            load_library()

        def many(qs, pe1, pe2):
            return remap_banded([q.contiguous() for q in qs], pe1, pe2,
                                cfg.kord, band=cfg.remap_band)

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
    subcycles.  Preserves q == const exactly."""
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
    chart = ctx.chart
    stag = ctx.stag if _use_exchange(cfg) else None

    F = delp.shape[0]
    Ny, Nx, K = ny + 2 * h, nx + 2 * h, cfg.npz
    for _ks in range(cfg.k_split):
        delp0 = delp
        tacc = [ops.zeros((F, Ny, Nx + 1, K)), ops.zeros((F, Ny + 1, Nx, K)),
                ops.zeros((F, Ny, Nx + 1, K)), ops.zeros((F, Ny + 1, Nx, K))]
        for _ in range(cfg.n_split):
            s = fill_substep(ops, u, v, delp, pt, chart=chart)
            out = d_sw_substep(
                s, m, ops, dt_acoustic, cfg.ptop, hord=cfg.hord,
                d2_bg=cfg.d2_bg, hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm,
                chart=chart, stag_tabs=stag, vtx_damp=cfg.vtx_damp)
            u, v, delp, pt = out.u, out.v, out.delp, out.pt
            if has_q:
                tacc = [a + b for a, b in zip(tacc, (out.uct_pad, out.vct_pad,
                                                     out.mfx_pad,
                                                     out.mfy_pad))]
            else:
                mfx_acc = mfx_acc + out.mfx
                mfy_acc = mfy_acc + out.mfy
        if has_q:
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
        nq = 0 if q is None else q.shape[-1]
        out = rm_many([pt] + [q[..., t] for t in range(nq)], pe1, pe2)
        pt = out[0]
        if q is not None:
            q = torch.stack(out[1:1 + nq], dim=-1)
        u, v = _remap_winds(u, v, ops.fill(delp, "x"), ctx.ak, ctx.bk,
                            cfg.ptop, h, ny, nx, rm)
        delp = delp_new

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
        w=state.w, delz=state.delz, phis=state.phis,
        ps=ps, omga=omga, ua=ua, va=va,
        mfx=mfx_acc, mfy=mfy_acc,
    )

"""Measured per-phase timing of the dycore step
(geosongpu_tpu/benchmark/phases.py).

Each phase runs as its own function in a chained loop (output feeds
input), with one device synchronisation per block of calls, so no
per-call synchronisation enters a phase's time: where the card sets the
pace, a phase's number is its pipelined device time; where the host
issues the work more slowly than the card runs it (the c48 paths), it is
the host's issue time.  The result is a PhaseTree: step -> {halo fill, substep x
n_split, vertical remap, forcing/physics} plus detail leaves, serialised
into BenchmarkRecord.phase_tree.

The leaves and their names are the original's.  Each leaf runs what the
model's step runs: the chart-corner fills and, where the configuration
selects it, the exchange-form damping divergence; the substep leaf takes
the fused kernels under pallas_dycore and the nonhydrostatic fields where
the configuration has them; the remap leaf is the step's remap block (the
model's own remap, the banded kernel for remap_band > 0: one multi-field
call, then u and v), where the original's times one call of the full
remap on pt and multiplies it by the number of fields.  remap_leaf(cfg)
names the form, for the record's extra.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..device import synchronize
from ..dycore.fv_dynamics import (_advect_tracers_accumulated, _remap_winds,
                                  _use_exchange)
from ..dycore.nh_solver import hydrostatic_delz
from ..dycore.sw import (_hydrostatic_fields, c_sw, d_sw_substep,
                         damping_divergence, fill_substep, transport_part,
                         wind_part)
from ..dycore.sw_fused import d_sw_substep_fused
from ..ops.kernels.dsw import nh_vertical_solve
from ..ops.vertical import interfaces_from_delp
from ..physics.held_suarez import held_suarez_forcing


REPS = 5   # blocks of `inner` calls a leaf is timed over


def _chain_time(fn: Callable, args, device: torch.device, inner: int = 30,
                reps: int = REPS) -> float:
    """Median seconds per call; calls chained (out -> in) where the output
    is a tuple as long as the arguments, one device sync per block of
    `inner` calls."""
    out = fn(*args)
    synchronize(device)
    n_args = len(args)
    ts = []
    for _ in range(reps):
        cur = args
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*cur)
            cur = out if isinstance(out, tuple) and len(out) == n_args else args
        synchronize(device)
        ts.append((time.perf_counter() - t0) / inner)
    ts.sort()
    return ts[len(ts) // 2]


# leaves whose time is already inside another leaf (the substep stage
# split, the NH solve inside the substep): reported, not accounted
_DETAIL_PREFIXES = ("substep: ", "nh vertical")


@dataclass
class PhaseTree:
    """Measured phase breakdown of one model step (seconds)."""

    full_step_s: float
    phases: Dict[str, float]  # leaf name -> s per STEP (already x n_split)

    @property
    def accounted_s(self) -> float:
        return sum(v for k, v in self.phases.items()
                   if not k.startswith(_DETAIL_PREFIXES))

    def to_dict(self) -> dict:
        tot = self.full_step_s
        return {
            "full_step_ms": 1e3 * tot,
            "phases_ms": {k: 1e3 * v for k, v in self.phases.items()},
            "phases_pct": {k: (100.0 * v / tot if tot else 0.0)
                           for k, v in self.phases.items()},
            "unaccounted_ms": 1e3 * max(0.0, tot - self.accounted_s),
        }

    def render(self) -> str:
        d = self.to_dict()
        lines = [f"step {d['full_step_ms']:.2f} ms"]
        for k, v in sorted(d["phases_ms"].items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<22s} {v:8.2f} ms  {d['phases_pct'][k]:5.1f}%")
        lines.append(f"  {'(unaccounted)':<22s} {d['unaccounted_ms']:8.2f} ms")
        return "\n".join(lines)


def remap_leaf(cfg) -> str:
    """What the tree's "vertical remap" leaf timed under `cfg`."""
    form = (f"remap_banded (band {cfg.remap_band})" if cfg.remap_band > 0
            else "remap_field")
    return (f"the step's remap block: {form}, one call on the scalar "
            f"fields, then u and v; x k_split {cfg.k_split}")


def measure_phases(model, state, inner: int = 30,
                   forcing_fn: Optional[Callable] = None) -> PhaseTree:
    """The phase tree of a dycore-driven model on its device.  Phases are
    timed as independent functions with chained inputs; a substep leaf is
    scaled by k_split * n_split to its cost per step.

    The eager substep is split further into its c_sw / transport / wind
    stages (hydrostatic fields; the fused substep keeps one leaf, its
    stages being kernels), and the z_tracer pass and the nonhydrostatic
    vertical solve get leaves of their own.

    forcing_fn(u, v, pt, delp) -> (u, v, pt): the model's column physics;
    defaults to Held-Suarez forcing."""
    cfg = model.config
    ctx = model.ctx
    ops, m, chart = ctx.ops, ctx.metrics, ctx.chart
    stag = ctx.stag if _use_exchange(cfg) else None
    device = ctx.device
    dt_ac = cfg.dt / (cfg.k_split * cfg.n_split)
    n_sub = cfg.k_split * cfg.n_split
    h, n = ops.h, ops.n
    isl = (slice(None), slice(h, h + n), slice(h, h + n))

    def timed(fn, args):
        return _chain_time(fn, args, device, inner=inner)

    full = timed(lambda s: model.step(s), (state,))

    nh = {}
    if not cfg.hydrostatic:
        nh = dict(w=state.w, delz=torch.where(
            state.delz > 1.0, state.delz,
            hydrostatic_delz(state.delp, state.pt, cfg.ptop)))

    def fill_then_slice(u, v, delp, pt):
        st = fill_substep(ops, u, v, delp, pt, chart=chart, **nh)
        return (st.pu[:, h:h + n + 1, h:h + n], st.pv[:, h:h + n, h:h + n + 1],
                st.pd_x[isl], st.pt_x[isl])

    prognostic = (state.u, state.v, state.delp, state.pt)
    fill_t = timed(fill_then_slice, prognostic)

    sub_fn = d_sw_substep_fused if cfg.pallas_dycore else d_sw_substep

    def one_substep(u, v, delp, pt):
        st = fill_substep(ops, u, v, delp, pt, chart=chart, **nh)
        o = sub_fn(st, m, ops, dt_ac, cfg.ptop, hord=cfg.hord,
                   d2_bg=cfg.d2_bg, advect_tracers=False, hord_mt=cfg.hord_mt,
                   hord_tm=cfg.hord_tm, chart=chart, stag_tabs=stag,
                   vtx_damp=cfg.vtx_damp)
        return o.u, o.v, o.delp, o.pt

    sub_t = timed(one_substep, prognostic)

    # ---- substep stage split (eager path, hydrostatic fields) -----------
    stage_phases: Dict[str, float] = {}
    if not cfg.pallas_dycore:
        st0 = fill_substep(ops, state.u, state.v, state.delp, state.pt,
                           chart=chart)

        def stage_csw(pu, pv):
            # one output: (uct, vct) are staggered the other way round from
            # (pu, pv), so the call is timed on fixed arguments
            return c_sw(st0._replace(pu=pu, pv=pv), m, 0.5 * dt_ac, cfg.ptop,
                        chart=chart)[0]

        csw_t = timed(stage_csw, (st0.pu, st0.pv))
        uct, vct, vort, ua, va = c_sw(st0, m, 0.5 * dt_ac, cfg.ptop,
                                      chart=chart)
        crx = uct * dt_ac * m.rdxc
        cry = vct * dt_ac * m.rdyc
        xfx = uct * dt_ac * m.dy
        yfx = vct * dt_ac * m.dx

        def stage_transport(pdx, pdy):
            dn, ptn, *_ = transport_part(st0._replace(pd_x=pdx, pd_y=pdy), m,
                                         crx, cry, xfx, yfx, cfg.hord, False,
                                         hord_tm=cfg.hord_tm)
            return dn, ptn

        tr_t = timed(stage_transport, (st0.pd_x, st0.pd_y))
        delp_n, pt_n = stage_transport(st0.pd_x, st0.pd_y)

        def refill(a):
            out = ops.fill(a, "x")
            return chart.apply_scalar(out, "x") if chart is not None else out

        def stage_wind(pu, pv):
            # the post-transport refill, the hydrostatic fields and the
            # damping divergence belong to the wind stage of the substep
            st = st0._replace(pu=pu, pv=pv)
            dfp = refill(delp_n[isl])
            ptf = refill(pt_n[isl])
            pkz_n, phi_n = _hydrostatic_fields(dfp, ptf, cfg.ptop)
            div = (damping_divergence(pu, pv, ua, va, uct, vct, m, ops, stag)
                   if stag is not None else None)
            return wind_part(st, m, uct, vct, crx, cry, ptf, pkz_n,
                             phi_n + m.phis, None, dt_ac, cfg.hord,
                             cfg.d2_bg, hord_mt=cfg.hord_mt,
                             vort=vort if chart is not None else None,
                             div_c_in=div, vtx_damp=cfg.vtx_damp)

        wind_t = timed(stage_wind, (st0.pu, st0.pv))
        stage_phases = {
            "substep: c_sw (xN)": csw_t * n_sub,
            "substep: transport (xN)": tr_t * n_sub,
            "substep: wind_part (xN)": wind_t * n_sub,
        }

    # ---- tracer z_tracer pass + NH vertical solve -----------------------
    if cfg.z_tracer and cfg.ntracers and state.q is not None:
        F, K = state.delp.shape[0], state.delp.shape[-1]
        Ny = Nx = n + 2 * h
        tacc = (ops.zeros((F, Ny, Nx + 1, K)), ops.zeros((F, Ny + 1, Nx, K)),
                ops.zeros((F, Ny, Nx + 1, K)), ops.zeros((F, Ny + 1, Nx, K)))

        def stage_tracer(q):
            return _advect_tracers_accumulated(
                q, state.delp, tacc, ops, m, cfg.hord, cfg.q_split, dt_ac,
                chart=chart, fused=cfg.pallas_dycore)

        stage_phases["tracer transport"] = timed(
            stage_tracer, (state.q,)) * cfg.k_split

    if not cfg.hydrostatic:
        # the substep's vertical glue (nh_vertical_solve, a kernel on the
        # card) on padded fields as the transport hands them over
        st_nh = fill_substep(ops, state.u, state.v, state.delp, state.pt,
                             chart=chart, **nh)

        def stage_nh(w, delz):
            return nh_vertical_solve(w, delz, st_nh.pt_x, st_nh.pd_x, dt_ac,
                                     cfg.ptop)

        stage_phases["nh vertical solve (xN)"] = timed(
            stage_nh, (st_nh.pw_x, st_nh.pz_x)) * n_sub

    # the remap block of a step's remap interval, as the step runs it: one
    # multi-field call on pt, the tracers (and w and the specific volume
    # where nonhydrostatic), then u and v on their staggered columns
    rm, rm_many = model.remap
    others = []
    if state.q is not None:
        others += [state.q[..., t] for t in range(state.q.shape[-1])]
    if not cfg.hydrostatic:
        others += [state.w, nh["delz"] / torch.clamp(state.delp, min=1e-3)]

    def remap_block(pt):
        pe1 = interfaces_from_delp(state.delp, cfg.ptop)
        pe2 = ctx.ak + ctx.bk * pe1[..., -1:]
        out = rm_many([pt] + others, pe1, pe2)
        _remap_winds(state.u, state.v, ops.fill(state.delp, "x"), ctx.ak,
                     ctx.bk, cfg.ptop, h, ops.ny, ops.nx, rm)
        return out[0]

    remap_t = timed(remap_block, (state.pt,))

    if forcing_fn is None:
        def forcing_fn(u, v, pt, delp):
            return held_suarez_forcing(u, v, pt, delp, model.lats, cfg.ptop,
                                       cfg.dt)

    forcing_t = timed(lambda u, v, pt: forcing_fn(u, v, pt, state.delp),
                      (state.u, state.v, state.pt))

    phases = {
        "halo_fill (xN)": fill_t * n_sub,
        "substep-minus-fill (xN)": max(sub_t - fill_t, 0.0) * n_sub,
        "vertical remap": remap_t * cfg.k_split,
        "forcing/physics": forcing_t,
    }
    phases.update(stage_phases)
    return PhaseTree(full_step_s=full, phases=phases)

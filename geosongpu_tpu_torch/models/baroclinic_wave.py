"""Jablonowski-Williamson (2006) baroclinic wave
(geosongpu_tpu/models/baroclinic_wave.py), run eagerly on one device.

The initial condition and the expected outcome come from a publication:
Jablonowski, C. and Williamson, D. L. (2006), "A baroclinic instability
test case for atmospheric model dynamical cores", Q. J. R. Meteorol. Soc.,
132, 2943-2975 (JW06).  The dycore must hold the analytically balanced
zonal state (JW06 section 3) and grow the overlaid perturbation into the
published wave (section 4: ps_min near-unchanged through day ~4, explosive
deepening days 7-10).

The analytic state is JW06 eqs. (2)-(8): eta-coordinate zonal jets, a
temperature in thermal-wind balance with them, a balancing surface
geopotential (terrain, carried by the context's PaddedMetrics.phis) and a
Gaussian zonal-wind perturbation at (20E, 40N).  It is built in numpy
float64 with the formulas of the reference and cast to float32 once, so
both packages start from the same state.  Winds are projected onto the
D-grid staggered points as components along the local chart basis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import DycoreConfig
from ..core.grid import GRAV, KAPPA, OMEGA, RADIUS, RDGAS, Grid, build_grid
from ..core.state import DycoreState
from ..core.topology import FACE_FRAMES, face_point
from ..core.vertical import hybrid_coordinate, sigma_coordinate
from ..device import DTYPE, to_torch
from ..dycore.fv_dynamics import (DycoreContext, _make_remap, build_context,
                                  fv_dynamics_step)
from ..dycore.sw import P00
from ..parallel.halo import symmetrize_shared_edges
from ..spans import span, spanned
from .held_suarez import HeldSuarezModel

# JW06 Table 1 parameters
ETA0 = 0.252
ETA_T = 0.2
U0 = 35.0
T0 = 288.0
GAMMA = 0.005          # lapse rate [K/m]
DELTA_T = 4.8e5        # empirical stratosphere temperature amplitude [K]
UP = 1.0               # perturbation amplitude [m/s]
PERT_LON = np.pi / 9.0     # 20 E
PERT_LAT = 2.0 * np.pi / 9.0   # 40 N
P0 = 1.0e5


def _t_mean(eta):
    """Horizontal-mean temperature profile, JW06 eqs. (4)-(5)."""
    t = T0 * eta ** (RDGAS * GAMMA / GRAV)
    return np.where(eta < ETA_T, t + DELTA_T * (ETA_T - eta) ** 5, t)


def _u_zonal(eta, lat):
    """Balanced zonal wind, JW06 eq. (2)."""
    eta_v = (eta - ETA0) * np.pi / 2.0
    return U0 * np.cos(eta_v) ** 1.5 * np.sin(2.0 * lat) ** 2


def _temperature(eta, lat):
    """Balanced temperature, JW06 eq. (6)."""
    eta_v = (eta - ETA0) * np.pi / 2.0
    a = RADIUS
    br1 = (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0)
           + 10.0 / 63.0)
    br2 = (8.0 / 5.0 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0)
           - np.pi / 4.0)
    return (_t_mean(eta)
            + 0.75 * (eta * np.pi * U0 / RDGAS) * np.sin(eta_v)
            * np.sqrt(np.cos(eta_v))
            * (br1 * 2.0 * U0 * np.cos(eta_v) ** 1.5 + br2 * a * OMEGA))


def _phi_surface(lat):
    """Balancing surface geopotential, JW06 eq. (7)."""
    eta_vs = (1.0 - ETA0) * np.pi / 2.0
    a = RADIUS
    br1 = (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0)
           + 10.0 / 63.0)
    br2 = (8.0 / 5.0 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0)
           - np.pi / 4.0)
    return U0 * np.cos(eta_vs) ** 1.5 * (
        br1 * U0 * np.cos(eta_vs) ** 1.5 + br2 * a * OMEGA)


def _u_perturbation(lat, lon):
    """Gaussian zonal-wind perturbation, JW06 eq. (8)."""
    rr = RADIUS / 10.0
    cosd = (np.sin(PERT_LAT) * np.sin(lat)
            + np.cos(PERT_LAT) * np.cos(lat) * np.cos(lon - PERT_LON))
    r = RADIUS * np.arccos(np.clip(cosd, -1.0, 1.0))
    return UP * np.exp(-((r / rr) ** 2))


def _basis_at(f, q):
    """Unit chart tangents (e1, e2) of face f at unit points q [..., 3]
    (the construction of core/grid.build_grid)."""
    _, a_, b_ = FACE_FRAMES[f]
    e1 = a_ - np.sum(a_ * q, -1, keepdims=True) * q
    e2 = b_ - np.sum(b_ * q, -1, keepdims=True) * q
    e1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = e2 / np.linalg.norm(e2, axis=-1, keepdims=True)
    return e1, e2


def _east_north(q):
    """Unit east/north vectors, latitude and longitude at unit points q
    [..., 3]."""
    x, y, z = q[..., 0], q[..., 1], q[..., 2]
    lam = np.arctan2(y, x)
    phi = np.arcsin(np.clip(z, -1.0, 1.0))
    east = np.stack([-np.sin(lam), np.cos(lam),
                     np.zeros_like(lam)], axis=-1)
    north = np.stack([-np.sin(phi) * np.cos(lam),
                      -np.sin(phi) * np.sin(lam),
                      np.cos(phi)], axis=-1)
    return east, north, phi, lam


def _stag_points(n: int):
    """Unit positions of the D-grid staggered points (geodesic edge
    midpoints, as core/grid.build_grid evaluates the metrics there):
    u-points [6, n+1, n, 3] on S/N cell edges, v-points [6, n, n+1, 3] on
    W/E edges."""
    s = np.linspace(-np.pi / 4, np.pi / 4, n + 1)
    corners = np.zeros((6, n + 1, n + 1, 3))
    for f in range(6):
        SJ, SI = np.meshgrid(s, s, indexing="ij")
        corners[f] = face_point(f, SI, SJ)
    upts = corners[:, :, :-1] + corners[:, :, 1:]
    upts /= np.linalg.norm(upts, axis=-1, keepdims=True)
    vpts = corners[:, :-1, :] + corners[:, 1:, :]
    vpts /= np.linalg.norm(vpts, axis=-1, keepdims=True)
    return upts, vpts


def jw_initial_state(config: DycoreConfig, grid: Grid, ak: np.ndarray,
                     bk: np.ndarray, device, perturb: bool = True):
    """The JW06 analytic state on `device` -> (DycoreState, phis), phis the
    unpadded [6, n, n] surface geopotential in float64."""
    n, nz = config.npx, config.npz
    ak, bk = np.asarray(ak), np.asarray(bk)

    ps = np.full((6, n, n), P0)
    pe = ak[None, None, None, :] + bk[None, None, None, :] * ps[..., None]
    p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
    eta = p_mid / P0

    # cell-centre latitudes/longitudes (interior of the padded grid)
    h = grid.h
    lat_c = np.asarray(grid.lat)[:, h:h + n, h:h + n][..., None]

    T = _temperature(eta, lat_c)
    # the dycore's discrete Exner (dycore/sw.py _hydrostatic_fields), so
    # that T = pt * pkz holds in the model's own discretization
    pk = (pe / P00) ** KAPPA
    peln = np.log(pe)
    pkz = (pk[..., 1:] - pk[..., :-1]) / (
        KAPPA * (peln[..., 1:] - peln[..., :-1]))
    pt = T / pkz
    delp = pe[..., 1:] - pe[..., :-1]

    # staggered winds: physical V = uz * east (JW06 has no meridional
    # wind), along the chart tangent e1 at u-points and e2 at v-points;
    # eta depends only on the vertical (ps is uniform)
    eta_col = eta[0, 0, 0][None, None, None, :]

    def project(points, which):
        tang = np.zeros_like(points)
        for f in range(6):
            e1, e2 = _basis_at(f, points[f])
            tang[f] = e1 if which == "u" else e2
        east, _, phi, lam = _east_north(points)
        uz = _u_zonal(eta_col, phi[..., None])
        if perturb:
            uz = uz + _u_perturbation(phi[..., None], lam[..., None])
        return uz * np.sum(tang * east, axis=-1)[..., None]

    upts, vpts = _stag_points(n)
    u = project(upts, "u")
    v = project(vpts, "v")
    phis = _phi_surface(lat_c[..., 0])

    t = lambda a: to_torch(a, device)
    z = lambda *shape: torch.zeros(shape, dtype=DTYPE, device=device)
    state = DycoreState(
        u=t(u), v=t(v), delp=t(delp), pt=t(pt),
        q=z(6, n, n, nz, config.ntracers), w=z(6, n, n, nz),
        delz=z(6, n, n, nz), phis=t(phis), ps=t(ps), omga=z(6, n, n, nz),
        ua=z(6, n, n, nz), va=z(6, n, n, nz),
        mfx=z(6, n, n + 1, nz), mfy=z(6, n + 1, n, nz))
    return state, phis


class BaroclinicWaveModel:
    """The grid and the static context (with the JW06 terrain) of one
    configuration on one device; `step` is the dynamics and the shared-edge
    symmetrization, with no forcing."""

    # what run_with_history records after each step, as the reference's
    HISTORY = {"ps_min": lambda s: s.ps.min(),
               "ps_max": lambda s: s.ps.max()}

    def __init__(self, config: DycoreConfig, grid: Grid, ctx: DycoreContext,
                 ak: np.ndarray, bk: np.ndarray):
        self.config = config
        self.grid = grid
        self.ctx = ctx
        self.ak, self.bk = ak, bk
        self.remap = _make_remap(config, ctx.device)

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    def init(self, perturb: bool = True) -> DycoreState:
        """The balanced JW06 state, with the wind perturbation if
        `perturb`."""
        return jw_initial_state(self.config, self.grid, self.ak, self.bk,
                                self.device, perturb=bool(perturb))[0]

    @spanned("dynamics")
    def dynamics(self, state: DycoreState) -> DycoreState:
        """The dynamics alone (no symmetrization)."""
        return fv_dynamics_step(state, self.ctx, remap=self.remap)

    @spanned("step")
    def step(self, state: DycoreState) -> DycoreState:
        state = self.dynamics(state)
        if self.config.edge_symmetrize:
            with span("symmetrize"):
                u, v = symmetrize_shared_edges(state.u, state.v)
                state = dataclasses.replace(state, u=u, v=v)
        state.check_f32()
        return state

    # `steps` steps, and the same with HISTORY after each step: the
    # Held-Suarez model's loops over this model's step
    run = HeldSuarezModel.run
    run_with_history = HeldSuarezModel.run_with_history


def build_model(config: DycoreConfig, device) -> BaroclinicWaveModel:
    """The JW06 model of `config` on `device`: the unperturbed state is
    built once for the terrain the context carries."""
    device = torch.device(device)
    with span("setup.grid"):
        grid = build_grid(config.npx, config.halo)
    with span("setup.vertical"):
        if config.vertical == "sigma":
            ak, bk = sigma_coordinate(config.npz, config.ptop)
        else:
            ak, bk = hybrid_coordinate(config.npz, config.ptop)
        ak, bk = np.asarray(ak), np.asarray(bk)
    with span("setup.context"):
        _, phis = jw_initial_state(config, grid, ak, bk, device,
                                   perturb=False)
        ctx = build_context(config, grid, ak, bk, device, phis=phis)
    return BaroclinicWaveModel(config, grid, ctx, ak, bk)

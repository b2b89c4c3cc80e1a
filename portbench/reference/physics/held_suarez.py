"""Frozen copy of geosongpu_tpu_torch/physics/held_suarez.py at commit
f902e7ad95fb, unchanged but for this note.

Held & Suarez (1994) forcing (geosongpu_tpu/physics/held_suarez.py).

Implicit relaxation of T toward the HS94 equilibrium profile and Rayleigh
friction on the staggered winds, plus a weak model-top sponge:
    T' = (T + dt kt Teq) / (1 + dt kt),    u' = u / (1 + dt kv).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.grid import KAPPA, Grid
from ..device import to_torch
from ..ops.vertical import interfaces_from_delp

SECONDS_PER_DAY = 86400.0
SIGMA_B = 0.7
KF = 1.0 / SECONDS_PER_DAY
KA = 1.0 / (40.0 * SECONDS_PER_DAY)
KS = 1.0 / (4.0 * SECONDS_PER_DAY)
DELTA_T_Y = 60.0
DELTA_THETA_Z = 10.0
T_MIN = 200.0
P00 = 1.0e5
SPONGE_P = 400.0        # Pa: Rayleigh sponge on winds above this pressure
SPONGE_TAU = 2.0 * SECONDS_PER_DAY


class HSLatitudes(NamedTuple):
    lat_c: torch.Tensor  # [6, n, n] cell centres (the forcing's only input)


def hs_latitudes(grid: Grid, device) -> HSLatitudes:
    h, n = grid.h, grid.n
    return HSLatitudes(lat_c=to_torch(grid.lat[:, h:h + n, h:h + n], device))


def t_equilibrium(lat: torch.Tensor, p_mid: torch.Tensor) -> torch.Tensor:
    """HS94 radiative-equilibrium temperature; lat [..., 1] vs p [..., K]."""
    sin2 = torch.sin(lat) ** 2
    cos2 = 1.0 - sin2
    pr = p_mid / P00
    t = (315.0 - DELTA_T_Y * sin2 - DELTA_THETA_Z * torch.log(pr) * cos2) \
        * pr ** KAPPA
    return torch.clamp_min(t, T_MIN)


def _k_boundary(sigma):
    return torch.clamp_min((sigma - SIGMA_B) / (1.0 - SIGMA_B), 0.0)


def _sponge(p):
    return (1.0 / SPONGE_TAU) * torch.clamp_min(
        (SPONGE_P - p) / SPONGE_P, 0.0) ** 2


def _stagger(a, dim):
    """2-point average onto the staggered points along dim (edge cells
    replicate)."""
    first = a.narrow(dim, 0, 1)
    last = a.narrow(dim, a.shape[dim] - 1, 1)
    return 0.5 * (torch.cat([first, a], dim=dim) + torch.cat([a, last], dim=dim))


def held_suarez_forcing(u, v, pt, delp, lats: HSLatitudes, ptop: float,
                        dt: float):
    """One dt of HS94 forcing on D-grid u/v and potential temperature pt.
    Returns (u', v', pt')."""
    pe = interfaces_from_delp(delp, ptop)
    p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
    ps = pe[..., -1:]
    sigma = p_mid / ps
    pk = (p_mid / P00) ** KAPPA

    t = pt * pk
    lat = lats.lat_c[..., None]
    teq = t_equilibrium(lat, p_mid)
    kt = KA + (KS - KA) * _k_boundary(sigma) * torch.cos(lat) ** 4
    t_new = (t + dt * kt * teq) / (1.0 + dt * kt)
    pt_new = t_new / pk

    kv_u = KF * _k_boundary(_stagger(sigma, 1)) + _sponge(_stagger(p_mid, 1))
    kv_v = KF * _k_boundary(_stagger(sigma, 2)) + _sponge(_stagger(p_mid, 2))
    return u / (1.0 + dt * kv_u), v / (1.0 + dt * kv_v), pt_new

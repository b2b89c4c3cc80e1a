"""Frozen copy of three of the column functions of
geosongpu_tpu_torch/physics/standalone.py at commit 3eef9d40c49f, the
primaries that the program's CUDA kernels follow operation for operation:
fill_q2_zero, gfdl_microphysics (with its fall speeds and implicit
sedimentation) and cup_gf_sh, unchanged.

Departures from that file: the other four column functions (buoyancy,
evap_subl_pdf, aer_activation, moist_rad_coup) are left out, since the
aquaplanet model calls none of them.  Departures of the copied functions
from the reference package's geosongpu_tpu/physics/standalone.py, which
they follow: its `lax.scan`s over K (the fill's borrowing and the
sedimentation) are Python loops over a copy with K in front, and its
`.at[...]` updates are slice updates; the arithmetic and its order are the
package's.

Arrays [..., K] float32, K minor and running from the model top to the
surface.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .thermo import (CP_AIR, GRAV, HLS, HLV, RDGAS, T_ICE, dqsat_dt, qsat,
                     qsat_ice, t_virtual)


def _k_first(*arrays):
    return tuple(a.movedim(-1, 0).contiguous() for a in arrays)


# --------------------------------------------------------------------------
# FillQ2Zero: conservative removal of negative tracer values
# --------------------------------------------------------------------------

def fill_q2_zero(q: torch.Tensor, delp: torch.Tensor) -> torch.Tensor:
    """Eliminate negative mixing ratios by borrowing mass from the layer
    below (top-down pass), then clip any residual negative in the bottom
    layer.  Column mass of q*delp is conserved except for the final clip.
    Arrays [..., K]."""
    qT, dT = _k_first(q, delp)
    deficit = torch.zeros_like(qT[0])   # mass deficit owed from above
    cols = []
    for k in range(qT.shape[0]):
        qk = qT[k] + deficit / dT[k]
        deficit = torch.clamp_max(qk, 0.0) * dT[k]
        cols.append(torch.clamp_min(qk, 0.0))
    return torch.stack(cols, dim=-1)


# --------------------------------------------------------------------------
# GFDLMicrophysics (1M-lite): the flagship column kernel
# --------------------------------------------------------------------------

class MicrophysicsOut(NamedTuple):
    t: torch.Tensor
    qv: torch.Tensor
    ql: torch.Tensor
    qr: torch.Tensor
    qi: torch.Tensor
    precip: torch.Tensor  # surface precip accumulated over dt [kg/m^2]


# ---- GFDL-1M process constants ------------------------------------------
HLF = HLS - HLV          # latent heat of fusion [J/kg]
RHO0 = 1.2               # reference air density [kg/m^3]
QL_CRIT = 5.0e-4         # Kessler autoconversion threshold [kg/kg]
TAU_AUTO = 1800.0        # autoconversion timescale [s]
C_ACC = 2.2              # rain-accretion rate coefficient
C_REVP = 0.3             # rain-evaporation ventilation coefficient
TAU_WBF = 600.0          # Bergeron-Findeisen deposition timescale [s]
VT_RAIN_MAX = 12.0       # clip on bulk rain fall speed [m/s]
VT_ICE_MAX = 1.5


def vt_rain(rho, qr):
    """Lin et al. (1983)-type bulk mass-weighted rain fall speed [m/s]:
    vt = 36.34 (rho qr)^0.2 sqrt(rho0/rho), clipped."""
    rq = torch.clamp_min(rho * qr, 0.0)
    return torch.clamp(36.34 * rq ** 0.2 * torch.sqrt(RHO0 / rho),
                       0.0, VT_RAIN_MAX)


def vt_ice(rho, qi):
    """Heymsfield & Donner (1990) bulk ice fall speed:
    vt = 3.29 (rho qi)^0.16, clipped."""
    rq = torch.clamp_min(rho * qi, 0.0)
    return torch.clamp(3.29 * rq ** 0.16, 0.0, VT_ICE_MAX)


def _sediment_implicit(q, delp, c):
    """Implicit upstream sedimentation: unconditionally stable for any
    Courant number c = vt dt / dz (rain falls through many layers per
    physics step).  Per layer (top -> surface): q' = (q delp + in) /
    ((1 + c) delp), out = q' c delp.  Returns (q', surface flux)."""
    qT, dT, cT = _k_first(q, delp, c)
    in_flux = torch.zeros_like(qT[0])
    cols = []
    for k in range(qT.shape[0]):
        qk = (qT[k] * dT[k] + in_flux) / (1.0 + cT[k])
        in_flux = qk * cT[k]
        cols.append(qk / dT[k])
    return torch.stack(cols, dim=-1), in_flux


def gfdl_microphysics(t, qv, ql, qr, qi, p, delp, dt: float
                      ) -> MicrophysicsOut:
    """Single-moment (GFDL-1M process set) bulk microphysics column:

      1. saturation adjustment w.r.t. liquid (2 Newton iterations),
      2. ice phase: homogeneous freezing below -40 C, Bigg (1953)-type
         heterogeneous freezing between -40 and 0 C, melting above 0 C
         limited by available sensible heat,
      3. Wegener-Bergeron-Findeisen vapour deposition onto ice and ice
         sublimation in ice-subsaturated air,
      4. warm rain: Kessler autoconversion + Lin-type accretion,
      5. sedimentation of rain and ice with Lin/Heymsfield-Donner bulk
         fall speeds through an implicit upstream pass (any Courant),
      6. rain evaporation with a (rho qr)^0.525 ventilation factor.

    All phase changes carry latent heating; column total water is
    conserved up to surface precipitation.  Vertical index runs from the
    model top to the surface."""
    rho = p / (RDGAS * torch.clamp_min(t, 150.0))
    dz = delp / (rho * GRAV)

    # --- 1. saturation adjustment (2 Newton iterations) ------------------
    for _ in range(2):
        qs0 = qsat(t, p)
        dq = (qv - qs0) / (1.0 + (HLV / CP_AIR) * dqsat_dt(t, p))
        cond = torch.where(dq > 0, dq, torch.maximum(dq, -ql))
        qv = qv - cond
        ql = ql + cond
        t = t + HLV / CP_AIR * cond

    # --- 2. freezing / melting -------------------------------------------
    tc = t - T_ICE
    zero = torch.zeros_like(ql)
    frz_hom = torch.where(tc < -40.0, ql, zero)
    # Bigg-type stochastic freezing rate, ~0 at 0C, fast by -30C; for very
    # cold layers exp overflows to inf, which 1 - exp(-inf) absorbs
    bigg = ql * (1.0 - torch.exp(
        -dt * 1.0e-4 * (torch.exp(0.66 * torch.clamp_min(-tc, 0.0)) - 1.0)))
    frz = torch.minimum(
        ql, torch.where((tc < 0.0) & (tc >= -40.0), bigg, zero) + frz_hom)
    melt = torch.where(
        tc > 0.0,
        torch.minimum(qi, CP_AIR * torch.clamp_min(tc, 0.0) / HLF), zero)
    ql = ql - frz + melt
    qi = qi + frz - melt
    t = t + (HLF / CP_AIR) * (frz - melt)

    # --- 3. WBF deposition / ice sublimation ------------------------------
    qs_i = qsat_ice(t, p)
    gam_i = 1.0 + (HLS / CP_AIR) * dqsat_dt(t, p)
    ice_presence = 1.0 - torch.exp(-qi / 1.0e-6)
    f_wbf = 1.0 - math.exp(-dt / TAU_WBF)
    dep = torch.where(
        tc < 0.0,
        torch.clamp_min(qv - qs_i, 0.0) / gam_i * ice_presence * f_wbf, zero)
    sub = torch.minimum(qi, torch.clamp_min(qs_i - qv, 0.0) / gam_i * f_wbf)
    qv = qv - dep + sub
    qi = qi + dep - sub
    t = t + (HLS / CP_AIR) * (dep - sub)

    # --- 4. warm rain ------------------------------------------------------
    auto = torch.clamp_min(ql - QL_CRIT, 0.0) \
        * (1.0 - math.exp(-dt / TAU_AUTO))
    acc = ql * (1.0 - torch.exp(
        -dt * C_ACC * torch.clamp_min(rho * qr, 0.0) ** 0.875))
    to_rain = torch.minimum(ql, auto + acc)
    ql = ql - to_rain
    qr = qr + to_rain

    # --- 5. sedimentation (rain + ice), implicit upstream -----------------
    cr = vt_rain(rho, qr) * dt / torch.clamp_min(dz, 1.0)
    qr, rain_out = _sediment_implicit(qr, delp, cr)
    ci = vt_ice(rho, qi) * dt / torch.clamp_min(dz, 1.0)
    qi, ice_out = _sediment_implicit(qi, delp, ci)
    precip = (rain_out + ice_out) / GRAV   # [kg/m^2 per dt]

    # --- 6. rain evaporation ----------------------------------------------
    qs1 = qsat(t, p)
    gam_l = 1.0 + (HLV / CP_AIR) * dqsat_dt(t, p)
    subsat = torch.clamp_min(qs1 - qv, 0.0)
    vent = 1.0 - torch.exp(
        -dt * C_REVP * torch.clamp_min(rho * qr, 0.0) ** 0.525)
    evap = torch.minimum(qr, subsat / gam_l * vent)
    qr = qr - evap
    qv = qv + evap
    t = t - HLV / CP_AIR * evap

    return MicrophysicsOut(t=t, qv=qv, ql=ql, qr=qr, qi=qi, precip=precip)


# --------------------------------------------------------------------------
# CupGfSh: shallow convection (bulk mass-flux lite)
# --------------------------------------------------------------------------

def cup_gf_sh(t, qv, p, delp, dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shallow cumulus mixing: where a layer is buoyantly unstable w.r.t.
    the layer above (virtual potential temperature decreasing with
    height), mix T and qv across that interface with a 3 h timescale.
    Returns (t', qv')."""
    theta_v = t_virtual(t, qv) * (1.0e5 / p) ** (RDGAS / CP_AIR)
    # instability: theta_v below > theta_v above (K increases downward)
    unstable = theta_v[..., 1:] > theta_v[..., :-1] + 0.1
    # mixing coefficient per interface
    mix = unstable.to(t.dtype) * ((1.0 - math.exp(-dt / 10800.0)) * 0.5)
    wsum = delp[..., :-1] + delp[..., 1:]

    def mix_field(a):
        flux = mix * (a[..., 1:] - a[..., :-1])  # downgradient (upward)
        da = torch.zeros_like(a)
        # a layer's sum takes the interface below first, then the one above
        da[..., :-1] += flux * delp[..., 1:] / wsum
        da[..., 1:] += -flux * delp[..., :-1] / wsum
        return a + da

    return mix_field(t), mix_field(qv)

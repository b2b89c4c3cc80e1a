"""Nonhydrostatic vertical acoustic solver (geosongpu_tpu/dycore/nh_solver.py).

The vertically implicit solve of the nonhydrostatic core: it advances the
vertically propagating acoustic/buoyancy dynamics of each column with a
backward-Euler scheme, which reduces to one tridiagonal solve per column.
The reference runs it as two `lax.scan`s over K in the glue between its
kernels, which its compiler keeps on the device.  Here the functions are
the plain PyTorch form: a Python loop over the K-1 interior interfaces,
forward and backward, vectorised over all columns, a handful of small
launches an interface.  The substeps run them only on the CPU: on the
card the glue that calls them (dycore/sw.py::nh_vertical_glue) is one
launch of the hand kernel nh_vertical_solve (ops/kernels/dsw.py,
csrc/nh_vertical_solve.cu), and these functions are its plain version.

Column model (TOA -> surface index order, rigid lid and ground):
  interfaces carry w [.., K+1] (w[0] = w[K] = 0), layers carry
  delz > 0 (geometric thickness), delp (fixed mass), pt.
  p_k   = full gas-law pressure  rho R T = (delp/(g delz)) R T
  p'_k  = p_k - p_hydro_k        (nonhydrostatic perturbation)
  dw/dt|_iface = -g [p'_k - p'_{k-1}] / (rho_bar dz_bar g)  (pressure form)
  d(delz)/dt|_layer = w_iface_above - w_iface_below

Linearizing p(delz) with the adiabatic bulk modulus (dp/d delz =
-gamma p/delz) and eliminating delz^{n+1} yields the tridiagonal system in
w^{n+1} solved below (Thomas algorithm).  Implicit => unconditionally
stable for vertical sound waves.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.grid import GRAV, KAPPA, RDGAS
from ..ops.vertical import interfaces_from_delp

GAMMA = 1.0 / (1.0 - KAPPA)  # cp/cv


def _thomas(a, b, c, d):
    """Tridiagonal solve along the last axis (vectorized Thomas).

    a: sub-diagonal [.., M] (a[...,0] unused), b: diagonal [.., M],
    c: super-diagonal (c[...,-1] unused), d: rhs [.., M].  The unknown
    index moves to the front for the sweeps, so that each of their steps
    reads and writes contiguous memory.
    """
    a, b, c, d = (x.movedim(-1, 0).contiguous() for x in (a, b, c, d))
    M = b.shape[0]
    cp = torch.zeros_like(b[0])
    dp = torch.zeros_like(b[0])
    cps, dps = [], []
    for i in range(M):
        denom = b[i] - a[i] * cp
        dp = (d[i] - a[i] * dp) / denom
        cp = c[i] / denom
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(b[0])
    xs = [None] * M
    for i in range(M - 1, -1, -1):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs, dim=-1)


def _exner_mid(pe):
    """Layer-mean Exner function pkz from interface pressures."""
    pk = (pe / 1.0e5) ** KAPPA
    peln = torch.log(pe)
    return (pk[..., 1:] - pk[..., :-1]) / (
        KAPPA * (peln[..., 1:] - peln[..., :-1]))


def full_pressure(delp, delz, pt, ptop):
    """Gas-law pressure per layer from mass, thickness and temperature
    (T = pt * pkz with pkz from the hydrostatic pe).
    Returns (p_full, p_mid_hydro, t)."""
    pe = interfaces_from_delp(delp, ptop)
    t = pt * _exner_mid(pe)
    rho = delp / (GRAV * torch.clamp(delz, min=1.0))
    p_full = rho * RDGAS * t
    p_mid_hydro = 0.5 * (pe[..., 1:] + pe[..., :-1])
    return p_full, p_mid_hydro, t


def vertical_acoustic_solve(w, delz, pt, delp, dt: float, ptop: float,
                            n_iter: int = 2
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One implicit vertical acoustic step (n_iter Newton linearizations).

    w:    [.., K+1] interface vertical velocity (the boundary values
          w[...,0] and w[...,K] are replaced by 0: rigid lid and ground)
    delz: [.., K] layer thickness (> 0)
    Returns (w', delz')."""
    w_in0 = w[..., 1:-1]
    zeros = torch.zeros_like(w[..., :1])
    # Gas-law pressure at the substep-start thickness: the Newton anchor.
    # Re-evaluations during the iteration follow the adiabat through that
    # anchor, p*(z) = p0 (z0/z)^gamma, so the slope used in the matrix
    # (s = gamma p*/z*) is the true derivative dp*/d(delz) and the fixed
    # point is the adiabatic backward-Euler solution.
    p0, p_hyd, _t = full_pressure(delp, delz, pt, ptop)
    delz0 = torch.clamp(delz, min=1.0)
    z_star = delz
    w_new = torch.cat([zeros, w_in0, zeros], dim=-1)   # n_iter = 0
    for _ in range(n_iter):
        # linearize p'(delz) around z_star:
        #   p'_k(delz) ~= p*_k - s*_k (delz - z*_k),  s* = gamma p*/z* > 0
        # with delz_k^{n+1} = delz_k^n + dt (w_{i=k} - w_{i=k+1})
        # (i = k is the top interface of layer k)
        zs = torch.clamp(z_star, min=1.0)
        p_star = p0 * (delz0 / zs) ** GAMMA
        ptil = p_star - p_hyd - GAMMA * p_star / zs * (delz - z_star)
        rho = delp / (GRAV * zs)
        rho_i = 0.5 * (rho[..., :-1] + rho[..., 1:])
        dz_i = 0.5 * (z_star[..., :-1] + z_star[..., 1:])
        s = GAMMA * p_star / zs

        # tridiagonal for interior interface w (M = K-1 unknowns):
        # w_i - w_i^n = (dt/(rho_i dz_i)) [ p'_below - p'_above ]@n+1
        alpha = dt / (rho_i * dz_i)
        dt_s_up = dt * s[..., :-1]            # layer above iface i
        dt_s_dn = dt * s[..., 1:]             # layer below
        b = 1.0 + alpha * (dt_s_up + dt_s_dn)
        a = -alpha * dt_s_up                  # couples to w_{i-1}
        c = -alpha * dt_s_dn                  # couples to w_{i+1}
        # excess pressure in the layer below an interface pushes it up
        rhs = w_in0 + alpha * (ptil[..., 1:] - ptil[..., :-1])
        x = _thomas(a, b, c, rhs)
        w_new = torch.cat([zeros, x, zeros], dim=-1)
        z_star = delz + dt * (w_new[..., :-1] - w_new[..., 1:])

    return w_new, z_star


def hydrostatic_delz(delp, pt, ptop):
    """The delz profile in exact discrete hydrostatic balance (p' == 0):
    rho R T = p_mid  =>  delz = delp R T / (g p_mid)."""
    pe = interfaces_from_delp(delp, ptop)
    t = pt * _exner_mid(pe)
    p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
    return delp * RDGAS * t / (GRAV * p_mid)

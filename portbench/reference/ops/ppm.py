"""Frozen copy of geosongpu_tpu_torch/ops/ppm.py at commit f902e7ad95fb,
unchanged but for this note.

Piecewise-parabolic (PPM) reconstruction and fluxes (geosongpu_tpu/ops/ppm.py).

Padded arrays [6, J, I, K]; `dim` is the flux axis (1 = y, 2 = x).
hord 6 is the unlimited 4th-order form, hord 8 the monotone
(Colella-Woodward) form.  Interface arrays have length N+1 along `dim`;
interface i sits between cells i-1 and i.
"""
from __future__ import annotations

import torch


def _shift(a: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """a[i+k] along `dim` with edge replication (finite junk at borders)."""
    if k == 0:
        return a
    n = a.shape[dim]
    if k > 0:
        pad = a.narrow(dim, n - 1, 1)
        return torch.cat([a.narrow(dim, k, n - k)] + [pad] * k, dim=dim)
    k = -k
    pad = a.narrow(dim, 0, 1)
    return torch.cat([pad] * k + [a.narrow(dim, 0, n - k)], dim=dim)


def _edges_ord4(q: torch.Tensor, dim: int) -> torch.Tensor:
    """al[i] = 7/12 (q[i-1] + q[i]) - 1/12 (q[i-2] + q[i+1])."""
    qm1 = _shift(q, -1, dim)
    qm2 = _shift(q, -2, dim)
    qp1 = _shift(q, +1, dim)
    return (7.0 / 12.0) * (qm1 + q) - (1.0 / 12.0) * (qm2 + qp1)


def _ppm_coeffs(q: torch.Tensor, dim: int, hord: int):
    """Per-cell parabola edges aL, aR (limited for hord 8) and a6."""
    if hord not in (6, 8):
        raise ValueError(f"hord must be 6 or 8, got {hord}")
    al = _edges_ord4(q, dim)
    aL = al
    aR = _shift(al, +1, dim)
    if hord == 8:
        extremum = (aR - q) * (q - aL) <= 0.0
        aL = torch.where(extremum, q, aL)
        aR = torch.where(extremum, q, aR)
        da = aR - aL
        a6 = 6.0 * (q - 0.5 * (aL + aR))
        aL = torch.where(a6 * da > da * da, 3.0 * q - 2.0 * aR, aL)
        da = aR - aL
        a6 = 6.0 * (q - 0.5 * (aL + aR))
        aR = torch.where(a6 * da < -da * da, 3.0 * q - 2.0 * aL, aR)
    a6 = 6.0 * (q - 0.5 * (aL + aR))
    return aL, aR, a6


def _iface(cell: torch.Tensor, side: str, dim: int) -> torch.Tensor:
    """cell array -> interface array: 'L' takes cell i-1, 'R' cell i."""
    n = cell.shape[dim]
    if side == "L":
        return torch.cat([cell.narrow(dim, 0, 1), cell], dim=dim)
    return torch.cat([cell, cell.narrow(dim, n - 1, 1)], dim=dim)


def ppm_flux(q: torch.Tensor, c: torch.Tensor, dim: int,
             hord: int = 8) -> torch.Tensor:
    """Upwind PPM interface value, time-averaged over the swept distance.
    q: padded cell means (N along dim); c: Courant numbers (N+1)."""
    aL, aR, a6 = _ppm_coeffs(q, dim, hord)
    da = aR - aL
    aR_l = _iface(aR, "L", dim)
    daL = _iface(da, "L", dim)
    a6L = _iface(a6, "L", dim)
    aL_r = _iface(aL, "R", dim)
    daR = _iface(da, "R", dim)
    a6R = _iface(a6, "R", dim)

    cpos = torch.clamp_min(c, 0.0)
    cneg = torch.clamp_min(-c, 0.0)
    f_pos = aR_l - 0.5 * cpos * (daL - (1.0 - (2.0 / 3.0) * cpos) * a6L)
    f_neg = aL_r + 0.5 * cneg * (daR + (1.0 - (2.0 / 3.0) * cneg) * a6R)
    return torch.where(c >= 0.0, f_pos, f_neg)


def upwind_flux(q: torch.Tensor, c: torch.Tensor, dim: int) -> torch.Tensor:
    """1st-order upwind interface value (C-grid half step)."""
    return torch.where(c >= 0.0, _iface(q, "L", dim), _iface(q, "R", dim))

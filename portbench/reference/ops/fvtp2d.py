"""Frozen copy of geosongpu_tpu_torch/ops/fvtp2d.py at commit f902e7ad95fb,
unchanged but for this note.

2-D flux-form transport, Lin-Rood inner updates (geosongpu_tpu/ops/fvtp2d.py).

Each direction's flux is computed from the field advected in the other
direction.  With mass fluxes mfx/mfy the returned fluxes are PPM value x
mass flux while the inner updates use the area fluxes, which preserves
q == const exactly.  All arrays padded [6, J, I, K].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ppm import ppm_flux

_AX_Y = 1
_AX_X = 2


class Fluxes2D(NamedTuple):
    fx: torch.Tensor   # [6, J, I+1, K]
    fy: torch.Tensor   # [6, J+1, I, K]


def ddx(iface: torch.Tensor) -> torch.Tensor:
    """Flux convergence along x: F[i] - F[i+1]."""
    return iface[:, :, :-1] - iface[:, :, 1:]


def ddy(iface: torch.Tensor) -> torch.Tensor:
    return iface[:, :-1, :] - iface[:, 1:, :]


def fvtp2d(qx, qy, crx, cry, xfx, yfx, area, hord: int = 8,
           mfx: Optional[torch.Tensor] = None,
           mfy: Optional[torch.Tensor] = None,
           rax: Optional[torch.Tensor] = None,
           ray: Optional[torch.Tensor] = None) -> Fluxes2D:
    """qx/qy: padded field with x-/y-order corners; crx/cry Courant numbers;
    xfx/yfx area fluxes; area [6, J, I, 1]; rax/ray optional precomputed
    1/(area + ddx(xfx)) and 1/(area + ddy(yfx))."""
    fyy = ppm_flux(qy, cry, _AX_Y, hord) * yfx
    if ray is None:
        ray = 1.0 / (area + ddy(yfx))
    q_i = (qy * area + ddy(fyy)) * ray

    fxx = ppm_flux(qx, crx, _AX_X, hord) * xfx
    if rax is None:
        rax = 1.0 / (area + ddx(xfx))
    q_j = (qx * area + ddx(fxx)) * rax

    fx = ppm_flux(q_i, crx, _AX_X, hord) * (xfx if mfx is None else mfx)
    fy = ppm_flux(q_j, cry, _AX_Y, hord) * (yfx if mfy is None else mfy)
    return Fluxes2D(fx=fx, fy=fy)

"""Frozen copy of geosongpu_tpu_torch/physics/thermo.py at commit
3eef9d40c49f, unchanged but for this note.

Moist thermodynamics helpers shared by the column physics
(geosongpu_tpu/physics/thermo.py): Bolton/Tetens saturation vapour
pressures, saturation mixing ratios, Clausius-Clapeyron slope and virtual
temperature.  Everything is elementwise float32 PyTorch.
"""
from __future__ import annotations

import torch

from ..core.grid import CP_AIR, GRAV, RDGAS  # noqa: F401  (re-exported)

RVGAS = 461.50
EPS = RDGAS / RVGAS          # 0.622
HLV = 2.501e6                # latent heat of vaporization [J/kg]
HLS = 2.836e6                # sublimation
T_ICE = 273.16


def esat_liquid(t: torch.Tensor) -> torch.Tensor:
    """Saturation vapour pressure over liquid [Pa] (Bolton 1980)."""
    tc = t - T_ICE
    return 611.2 * torch.exp(17.67 * tc / (tc + 243.5))


def esat_ice(t: torch.Tensor) -> torch.Tensor:
    """Over ice (Murphy-Koop simplified)."""
    tc = t - T_ICE
    return 611.2 * torch.exp(21.87 * tc / (tc + 265.5))


def _mixing_ratio(es: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    es = torch.minimum(es, 0.9 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def qsat(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Saturation mixing ratio over liquid [kg/kg]."""
    return _mixing_ratio(esat_liquid(t), p)


def qsat_ice(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return _mixing_ratio(esat_ice(t), p)


def dqsat_dt(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """d(qsat)/dT via Clausius-Clapeyron."""
    return qsat(t, p) * HLV / (RVGAS * t * t)


def t_virtual(t: torch.Tensor, qv: torch.Tensor, q_cond=0.0) -> torch.Tensor:
    return t * (1.0 + (1.0 / EPS - 1.0) * qv - q_cond)

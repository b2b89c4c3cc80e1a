"""Frozen copy of geosongpu_tpu_torch/core/vertical.py at commit f902e7ad95fb,
unchanged but for this note.

Hybrid sigma-pressure vertical coordinate (ak/bk) setups.

The port's own copy of geosongpu_tpu/core/vertical.py (numpy only).  It
generates the coordinate:

    pe[k] = ak[k] + bk[k] * ps      (k = 0..nz interfaces, TOA -> surface)

`sigma_coordinate` is a pure-sigma ladder (what Held & Suarez 1994 uses);
`hybrid_coordinate` transitions smoothly from pressure levels aloft to
terrain-following sigma below, similar in spirit to GEOS L72.
"""
from __future__ import annotations

import numpy as np


def sigma_coordinate(nz: int, ptop: float = 100.0, p_ref: float = 1.0e5):
    """Pure sigma levels, equally spaced in sigma.

    Returns (ak, bk) float32 arrays of length nz+1.
    """
    bk = np.linspace(0.0, 1.0, nz + 1)
    ak = ptop * (1.0 - bk)
    return ak.astype(np.float32), bk.astype(np.float32)


def hybrid_coordinate(nz: int, ptop: float = 100.0, p_ref: float = 1.0e5,
                      p_sigma: float = 2.0e4):
    """Hybrid coordinate: pure pressure above `p_sigma`, blending to pure
    sigma at the surface.  Interfaces are equally spaced in a stretched
    coordinate so that layer thickness grows smoothly from top to bottom.
    """
    # target full-pressure profile at ps = p_ref, stretched (thin layers
    # near the top, thicker below) via a squared ramp
    x = np.linspace(0.0, 1.0, nz + 1)
    pe_ref = ptop + (p_ref - ptop) * x**1.6
    # blend factor: 0 where pe_ref < p_sigma (pure pressure), ->1 at surface
    t = np.clip((pe_ref - p_sigma) / (p_ref - p_sigma), 0.0, 1.0)
    bk = t**1.2
    ak = pe_ref - bk * p_ref
    ak[0] = ptop
    bk[0] = 0.0
    ak[-1] = 0.0
    bk[-1] = 1.0
    return ak.astype(np.float32), bk.astype(np.float32)

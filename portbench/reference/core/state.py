"""Frozen copy of geosongpu_tpu_torch/core/state.py at commit f902e7ad95fb,
unchanged but for this note.

Dycore state (geosongpu_tpu/core/state.py): the same fields and shapes,
as a dataclass of float32 tensors."""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..device import DTYPE, to_numpy, to_torch
from .config import DycoreConfig
from .grid import KAPPA


@dataclass
class DycoreState:
    # prognostic
    u: torch.Tensor      # [6, n+1, n, nz] D-grid x-wind [m/s]
    v: torch.Tensor      # [6, n, n+1, nz] D-grid y-wind [m/s]
    delp: torch.Tensor   # [6, n, n, nz] layer pressure thickness [Pa]
    pt: torch.Tensor     # [6, n, n, nz] potential temperature [K]
    q: torch.Tensor      # [6, n, n, nz, ntracers]
    # nonhydrostatic extension (passive in hydrostatic mode)
    w: torch.Tensor      # [6, n, n, nz]
    delz: torch.Tensor   # [6, n, n, nz]
    phis: torch.Tensor   # [6, n, n] surface geopotential
    # diagnostics
    ps: torch.Tensor     # [6, n, n] surface pressure [Pa]
    omga: torch.Tensor   # [6, n, n, nz]
    ua: torch.Tensor     # [6, n, n, nz]
    va: torch.Tensor     # [6, n, n, nz]
    # accumulated mass fluxes over a remap interval
    mfx: torch.Tensor    # [6, n, n+1, nz]
    mfy: torch.Tensor    # [6, n+1, n, nz]

    def check_f32(self) -> None:
        """Raise if any field left float32 (an f64 input promotes
        silently in torch)."""
        for f in fields(self):
            t = getattr(self, f.name)
            if t.dtype != DTYPE:
                raise TypeError(f"state field {f.name} is {t.dtype}, "
                                f"expected {DTYPE}")


def init_state(config: DycoreConfig, ak: np.ndarray, bk: np.ndarray,
               device, perturb: float = 0.0, seed: int = 0) -> DycoreState:
    """Isothermal resting atmosphere (T = 300 K) with an optional pt
    perturbation.  The noise comes from a seeded numpy generator: the
    reference's jax.random stream cannot be reproduced, so parity tests
    start from the reference's own state (state_from_numpy)."""
    n, nz = config.npx, config.npz
    p_ref = 1.0e5
    ak_t = to_torch(ak, device)
    bk_t = to_torch(bk, device)
    ps = torch.full((6, n, n), p_ref, dtype=DTYPE, device=device)
    pe = ak_t + bk_t * ps[..., None]
    delp = pe[..., 1:] - pe[..., :-1]
    p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
    pt = 300.0 * (p_ref / p_mid) ** KAPPA
    if perturb:
        rng = np.random.default_rng(seed)
        noise = rng.standard_normal(tuple(pt.shape)).astype(np.float32)
        pt = pt + perturb * to_torch(noise, device)

    z = lambda *shape: torch.zeros(shape, dtype=DTYPE, device=device)
    return DycoreState(
        u=z(6, n + 1, n, nz), v=z(6, n, n + 1, nz),
        delp=delp, pt=pt, q=z(6, n, n, nz, config.ntracers),
        w=z(6, n, n, nz), delz=z(6, n, n, nz), phis=z(6, n, n),
        ps=ps, omga=z(6, n, n, nz), ua=z(6, n, n, nz), va=z(6, n, n, nz),
        mfx=z(6, n, n + 1, nz), mfy=z(6, n + 1, n, nz))


def state_from_numpy(arrays: dict, device) -> DycoreState:
    """{field name: array} (e.g. the reference's state as numpy) -> state."""
    return DycoreState(**{f.name: to_torch(arrays[f.name], device)
                          for f in fields(DycoreState)})


def state_to_numpy(state: DycoreState) -> dict:
    return {f.name: to_numpy(getattr(state, f.name))
            for f in fields(DycoreState)}

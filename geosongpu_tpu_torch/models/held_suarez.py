"""Held-Suarez model: dynamics + HS94 forcing + shared-edge symmetrization
(geosongpu_tpu/models/held_suarez.py), run eagerly on one device."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import DycoreConfig
from ..core.grid import Grid, build_grid
from ..core.state import DycoreState, init_state
from ..core.vertical import hybrid_coordinate, sigma_coordinate
from ..dycore.fv_dynamics import (DycoreContext, _make_remap, build_context,
                                  fv_dynamics_step)
from ..parallel.halo import symmetrize_shared_edges
from ..physics.held_suarez import (HSLatitudes, held_suarez_forcing,
                                   hs_latitudes)


class HeldSuarezModel:
    """The grid, static context and latitudes for one configuration on one
    device; `step` advances a DycoreState by one model step."""

    def __init__(self, config: DycoreConfig, grid: Grid, ctx: DycoreContext,
                 lats: HSLatitudes, ak: np.ndarray, bk: np.ndarray):
        self.config = config
        self.grid = grid
        self.ctx = ctx
        self.lats = lats
        self.ak, self.bk = ak, bk
        self.remap = _make_remap(config, ctx.device)

    @property
    def device(self) -> torch.device:
        return self.ctx.device

    def init(self, perturb: float = 1.0e-3, seed: int = 0) -> DycoreState:
        return init_state(self.config, self.ak, self.bk, self.device,
                          perturb=perturb, seed=seed)

    def dynamics(self, state: DycoreState) -> DycoreState:
        """The dynamics alone (no forcing, no symmetrization)."""
        return fv_dynamics_step(state, self.ctx, remap=self.remap)

    def step(self, state: DycoreState) -> DycoreState:
        cfg = self.config
        state = self.dynamics(state)
        u, v, pt = held_suarez_forcing(state.u, state.v, state.pt,
                                       state.delp, self.lats, cfg.ptop,
                                       cfg.dt)
        if cfg.edge_symmetrize:
            u, v = symmetrize_shared_edges(u, v)
        out = dataclasses.replace(state, u=u, v=v, pt=pt)
        out.check_f32()
        return out

    def run(self, state: DycoreState, steps: int) -> DycoreState:
        for _ in range(steps):
            state = self.step(state)
        return state


def build_model(config: DycoreConfig, device) -> HeldSuarezModel:
    device = torch.device(device)
    grid = build_grid(config.npx, config.halo)
    if config.vertical == "sigma":
        ak, bk = sigma_coordinate(config.npz, config.ptop)
    else:
        ak, bk = hybrid_coordinate(config.npz, config.ptop)
    ctx = build_context(config, grid, ak, bk, device)
    return HeldSuarezModel(config, grid, ctx, hs_latitudes(grid, device),
                           ak, bk)

"""Held-Suarez model: dynamics + HS94 forcing + shared-edge symmetrization
(geosongpu_tpu/models/held_suarez.py), run eagerly on one device.

`forcing(state, lats)` is the column physics alone, on the latitudes it is
given: the model's own, or a sharded step's block-local ones
(parallel/subtile.build_mesh_stepper)."""
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
from ..spans import span, spanned


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

    @spanned("dynamics")
    def dynamics(self, state: DycoreState) -> DycoreState:
        """The dynamics alone (no forcing, no symmetrization)."""
        return fv_dynamics_step(state, self.ctx, remap=self.remap)

    @spanned("forcing")
    def forcing(self, state: DycoreState, lats: HSLatitudes = None
                ) -> DycoreState:
        """HS94 forcing on `lats` (default: the model's)."""
        cfg = self.config
        u, v, pt = held_suarez_forcing(
            state.u, state.v, state.pt, state.delp,
            self.lats if lats is None else lats, cfg.ptop, cfg.dt)
        return dataclasses.replace(state, u=u, v=v, pt=pt)

    @spanned("step")
    def step(self, state: DycoreState) -> DycoreState:
        out = self.forcing(self.dynamics(state))
        if self.config.edge_symmetrize:
            with span("symmetrize"):
                u, v = symmetrize_shared_edges(out.u, out.v)
                out = dataclasses.replace(out, u=u, v=v)
        out.check_f32()
        return out

    def run(self, state: DycoreState, steps: int) -> DycoreState:
        for _ in range(steps):
            state = self.step(state)
        return state

    # what run_with_history records after each step, as the reference's
    # run_with_history does: the mean, min and max surface pressure, max |u|
    # and mean pt
    HISTORY = {"ps_mean": lambda s: s.ps.mean(),
               "ps_min": lambda s: s.ps.min(),
               "ps_max": lambda s: s.ps.max(),
               "umax": lambda s: s.u.abs().max(),
               "tmean": lambda s: s.pt.mean()}

    def run_with_history(self, state: DycoreState, steps: int):
        """`steps` steps -> (state, {diagnostic: [steps] tensor}) with each
        diagnostic of HISTORY after each step."""
        rows = []
        for _ in range(steps):
            state = self.step(state)
            rows.append(torch.stack([d(state) for d in self.HISTORY.values()]))
        hist = torch.stack(rows) if rows else torch.zeros(
            (0, len(self.HISTORY)), dtype=state.ps.dtype,
            device=state.ps.device)
        return state, {n: hist[:, i] for i, n in enumerate(self.HISTORY)}


def build_model(config: DycoreConfig, device, model_cls=HeldSuarezModel):
    """The model of `config` on `device`; model_cls: HeldSuarezModel or a
    subclass with its constructor."""
    device = torch.device(device)
    with span("setup.grid"):
        grid = build_grid(config.npx, config.halo)
    with span("setup.vertical"):
        if config.vertical == "sigma":
            ak, bk = sigma_coordinate(config.npz, config.ptop)
        else:
            ak, bk = hybrid_coordinate(config.npz, config.ptop)
    with span("setup.context"):
        ctx = build_context(config, grid, ak, bk, device)
    return model_cls(config, grid, ctx, hs_latitudes(grid, device), ak, bk)

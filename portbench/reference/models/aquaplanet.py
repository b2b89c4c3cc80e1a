"""The aquaplanet model in plain PyTorch: the reference Held-Suarez model's
grid, context and dynamics (models/held_suarez.py) with the moist initial
state and the moist physics chain of the reference package's
geosongpu_tpu/models/aquaplanet.py, written from the program's
geosongpu_tpu_torch/models/aquaplanet.py at commit 3eef9d40c49f.

The hydrostatic FV dycore advects vapour, cloud liquid and rain
(q[..., 0] = qv, q[..., 1] = ql, q[..., 2] = qr), and the physics chain of
a step is

  conservative filling of negative tracer values (fill_q2_zero)
  -> surface fluxes (bulk formulas over the prescribed 'Qobs' SST(lat))
  -> shallow-convective mixing (cup_gf_sh)
  -> GFDL single-moment microphysics
  -> Held-Suarez radiative relaxation.

Departures from the program's file: the chain always runs the plain
column functions of physics/standalone.py (the program's
`pallas_microphysics` switch, which sends the fill, the shallow convection
and the microphysics to its CUDA kernels, is not read); no spans; no
sharded entry (`physics` takes no block-local latitudes).  Departures
from the reference package's model: the column sums are float64 scans
(ops/vertical.py) in place of its triangular matmuls, as in the rest of
this reference, which moves pkz by ~1e-5 relative and so the saturation
adjustment's condensate (tests/test_torch_aquaplanet.py says by how
much).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.config import DycoreConfig
from ..core.state import DycoreState
from ..dycore.fv_dynamics import exner_mid
from ..ops.vertical import interfaces_from_delp
from ..physics import standalone as columns
from ..physics.held_suarez import held_suarez_forcing
from ..physics.thermo import CP_AIR, GRAV, RDGAS, qsat
from . import held_suarez

CD = 1.2e-3   # bulk transfer coefficient of the surface fluxes


def sst_qobs(lat: torch.Tensor) -> torch.Tensor:
    """Aqua-Planet Experiment 'Qobs' SST profile [K]."""
    phi = torch.clamp(lat.abs(), 0.0, torch.pi / 3)
    x = torch.sin(1.5 * phi) ** 2
    return 273.16 + 27.0 * (1.0 - 0.5 * (x + x * x))


class AquaplanetModel(held_suarez.HeldSuarezModel):
    """The reference Held-Suarez model with the moist initial state and
    the moist physics chain as its forcing."""

    def __init__(self, config: DycoreConfig, *args):
        if config.ntracers < 3:
            raise ValueError("aquaplanet needs the qv/ql/qr tracers "
                             f"(ntracers >= 3), got {config.ntracers}")
        super().__init__(config, *args)
        self.sst = sst_qobs(self.lats.lat_c)

    def init(self, perturb: float = 1.0e-3, seed: int = 0) -> DycoreState:
        """The dry initial state with 60% relative humidity below
        sigma = 0.5 and 1e-6 kg/kg aloft."""
        state = super().init(perturb=perturb, seed=seed)
        ptop = self.config.ptop
        t = state.pt * exner_mid(state.delp, ptop)
        pe = interfaces_from_delp(state.delp, ptop)
        p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
        sigma = p_mid / pe[..., -1:]
        q = state.q.clone()
        q[..., 0] = torch.where(sigma > 0.5, 0.6 * qsat(t, p_mid),
                                torch.full_like(t, 1e-6))
        return dataclasses.replace(state, q=q)

    def physics(self, state: DycoreState) -> DycoreState:
        """The moist physics chain on the state the dynamics left."""
        cfg = self.config
        sst, dt = self.sst, cfg.dt
        delp = state.delp.contiguous()
        pkz = exner_mid(delp, cfg.ptop)
        t = state.pt * pkz
        pe = interfaces_from_delp(delp, cfg.ptop)
        p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
        # clean advection undershoots conservatively before physics
        qv, ql, qr = (columns.fill_q2_zero(state.q[..., n], delp)
                      for n in range(3))

        # ---- surface fluxes (bulk, lowest layer) ------------------------
        wind = torch.sqrt(state.ua[..., -1] ** 2
                          + state.va[..., -1] ** 2) + 1.0
        rho_s = p_mid[..., -1] / (RDGAS * t[..., -1])
        dp_bot = delp[..., -1]
        qs_sst = qsat(sst, pe[..., -1])
        evap = CD * wind * rho_s * torch.clamp_min(qs_sst - qv[..., -1], 0.0)
        shf = CD * wind * rho_s * CP_AIR * (sst - t[..., -1])
        qv[..., -1] += evap * GRAV * dt / dp_bot
        t[..., -1] += shf * GRAV * dt / (CP_AIR * dp_bot)

        # ---- shallow convection -----------------------------------------
        t, qv = columns.cup_gf_sh(t, qv, p_mid, delp, dt)

        # ---- microphysics -----------------------------------------------
        mp = columns.gfdl_microphysics(t, qv, ql, qr, torch.zeros_like(ql),
                                       p_mid, delp, dt)

        # ---- radiative relaxation (Held-Suarez style, weak) -------------
        q = torch.stack([mp.qv, mp.ql, mp.qr] + [
            state.q[..., n] for n in range(3, state.q.shape[-1])], dim=-1)
        u, v, pt = held_suarez_forcing(state.u, state.v, mp.t / pkz,
                                       state.delp, self.lats, cfg.ptop, dt)
        return dataclasses.replace(state, u=u, v=v, pt=pt, q=q)

    # the step is the Held-Suarez model's, with the moist chain as forcing
    forcing = physics


def build_model(config: DycoreConfig, device) -> AquaplanetModel:
    return held_suarez.build_model(config, device, AquaplanetModel)

"""Aquaplanet model: moist dynamics over a zonally uniform ocean
(geosongpu_tpu/models/aquaplanet.py).

The hydrostatic FV dycore advects vapour, cloud liquid and rain, and the
physics chain of a step is

  conservative filling of negative tracer values (fill_q2_zero)
  -> surface fluxes (bulk formulas over the prescribed 'Qobs' SST(lat))
  -> shallow-convective mixing (cup_gf_sh)
  -> GFDL single-moment microphysics (saturation adjustment, rain,
     sedimentation, latent heating)
  -> Held-Suarez radiative relaxation (keeps the run bounded without a
     radiation scheme).

Tracer layout: q[..., 0] = qv, q[..., 1] = ql, q[..., 2] = qr.

Spans: `physics` around the chain, and inside it `surface_fluxes` around
the bulk fluxes and `relaxation` around the tracer re-stack and the
Held-Suarez relaxation, beside the kernel wrappers' `kernel.*` spans.

With `pallas_microphysics=True` the fill of the three tracers (one call of
fill_q2_zero_tracers on the state's tracer array), the shallow convection
and the microphysics go through the kernel wrappers of
ops/kernels/{columns,microphysics}.py: CUDA kernels for a state on a card,
their plain versions for one on the CPU.  With False they are the
primaries of physics/standalone.py everywhere.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.config import DycoreConfig
from ..core.state import DycoreState
from ..dycore.fv_dynamics import exner_mid
from ..ops.kernels import columns as kcolumns
from ..ops.kernels import microphysics as kmicro
from ..ops.kernels.build import load_library
from ..ops.vertical import interfaces_from_delp
from ..physics import standalone as primary
from ..physics.held_suarez import held_suarez_forcing
from ..physics.thermo import CP_AIR, GRAV, RDGAS, qsat
from ..spans import span, spanned
from . import held_suarez

CD = 1.2e-3   # bulk transfer coefficient of the surface fluxes


def sst_qobs(lat: torch.Tensor) -> torch.Tensor:
    """Aqua-Planet Experiment 'Qobs' SST profile [K]."""
    phi = torch.clamp(lat.abs(), 0.0, torch.pi / 3)
    x = torch.sin(1.5 * phi) ** 2
    return 273.16 + 27.0 * (1.0 - 0.5 * (x + x * x))


class AquaplanetModel(held_suarez.HeldSuarezModel):
    """The Held-Suarez model's grid, context and dynamics with the moist
    initial state and the moist physics chain."""

    def __init__(self, config: DycoreConfig, *args):
        if config.ntracers < 3:
            raise ValueError("aquaplanet needs the qv/ql/qr tracers "
                             f"(ntracers >= 3), got {config.ntracers}")
        super().__init__(config, *args)
        if config.pallas_microphysics and self.device.type == "cuda":
            load_library()   # a card without a working build fails here
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

    def microphysics_inputs(self, state: DycoreState, sst=None):
        """The physics chain up to the microphysics: filling, surface fluxes
        (over `sst`, default the model's) and shallow convection -> (pkz,
        (t, qv, ql, qr, qi, p_mid, delp, dt)), the second being the
        microphysics' arguments."""
        cfg = self.config
        sst = self.sst if sst is None else sst
        dt = cfg.dt
        delp = state.delp.contiguous()
        pkz = exner_mid(delp, cfg.ptop)
        t = state.pt * pkz
        pe = interfaces_from_delp(delp, cfg.ptop)
        p_mid = 0.5 * (pe[..., 1:] + pe[..., :-1])
        # clean advection undershoots conservatively before physics
        if cfg.pallas_microphysics:
            qv, ql, qr = kcolumns.fill_q2_zero_tracers(state.q.contiguous(),
                                                       delp, 3)
            shallow = kcolumns.cup_gf_sh
        else:
            qv, ql, qr = (primary.fill_q2_zero(state.q[..., n], delp)
                          for n in range(3))
            shallow = primary.cup_gf_sh

        # ---- surface fluxes (bulk, lowest layer) ------------------------
        with span("surface_fluxes"):
            wind = torch.sqrt(state.ua[..., -1] ** 2
                              + state.va[..., -1] ** 2) + 1.0
            rho_s = p_mid[..., -1] / (RDGAS * t[..., -1])
            dp_bot = delp[..., -1]
            qs_sst = qsat(sst, pe[..., -1])
            evap = CD * wind * rho_s * torch.clamp_min(qs_sst - qv[..., -1],
                                                       0.0)
            shf = CD * wind * rho_s * CP_AIR * (sst - t[..., -1])
            qv[..., -1] += evap * GRAV * dt / dp_bot
            t[..., -1] += shf * GRAV * dt / (CP_AIR * dp_bot)

        # ---- shallow convection -----------------------------------------
        t, qv = shallow(t, qv, p_mid, delp, dt)
        return pkz, (t, qv, ql, qr, torch.zeros_like(ql), p_mid, delp, dt)

    @spanned("physics")
    def physics(self, state: DycoreState, lats=None) -> DycoreState:
        """The moist physics chain alone, on the state the dynamics left;
        lats: block-local latitudes (the SST follows them), default the
        model's."""
        cfg = self.config
        microphysics = (kmicro.gfdl_microphysics if cfg.pallas_microphysics
                        else primary.gfdl_microphysics)
        sst = None if lats is None else sst_qobs(lats.lat_c)
        pkz, args = self.microphysics_inputs(state, sst)
        t, qv, ql, qr, _qi, _precip = microphysics(*args)

        # ---- radiative relaxation (Held-Suarez style, weak) -------------
        with span("relaxation"):
            q = torch.stack([qv, ql, qr] + [state.q[..., n] for n in range(
                3, state.q.shape[-1])], dim=-1)
            u, v, pt = held_suarez_forcing(
                state.u, state.v, t / pkz, state.delp,
                self.lats if lats is None else lats, cfg.ptop, cfg.dt)
        return dataclasses.replace(state, u=u, v=v, pt=pt, q=q)

    # the step is the Held-Suarez model's, with the moist chain as forcing
    forcing = physics

    # run_with_history records the mean surface pressure, max |u|, mean
    # vapour and the (unrecorded) precipitation total after each step
    HISTORY = {"ps_mean": lambda s: s.ps.mean(),
               "umax": lambda s: s.u.abs().max(),
               "qv_mean": lambda s: s.q[..., 0].mean(),
               "precip_total": lambda s: torch.zeros_like(s.ps[0, 0, 0])}


def build_model(config: DycoreConfig, device) -> AquaplanetModel:
    return held_suarez.build_model(config, device, AquaplanetModel)

"""Aquaplanet pipeline task (geosongpu_tpu/harness/tasks/aquaplanet.py).

The HeldSuarez task's run on the moist model:

  Validation / All : one gated moist run at the experiment's configuration
  Benchmark        : the pair eager vs fused, where the fused member takes
                     the substep kernels and the column-physics kernels
                     (pallas_dycore and pallas_microphysics: dsw_tracer_acc,
                     fill_q2_zero, cup_gf_sh, gfdl_microphysics), each with
                     a measured phase tree whose forcing leaf is the moist
                     physics chain, and the round-over-round comparison
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..environment import Environment
from ..exceptions import CICheckException
from ..registry import Registry
from .held_suarez import HeldSuarez


@Registry.register
class Aquaplanet(HeldSuarez):
    key = "aq"
    fused = {"pallas_dycore": True, "pallas_microphysics": True}
    fields = ("u", "v", "delp", "pt", "q", "ps")

    def build_model(self, dyc, device):
        from ...models.aquaplanet import build_model

        return build_model(dyc, device)

    def phase_forcing(self, model, state):
        def forcing_fn(u, v, pt, delp):
            out = model.physics(dataclasses.replace(state, u=u, v=v, pt=pt,
                                                    delp=delp))
            return out.u, out.v, out.pt
        return forcing_fn

    def check(self, config, env: Environment) -> bool:
        state = env.get("aq.final_state")
        records = env.get("aq.records")
        if state is None or not records:
            return False
        q = state.q.cpu().numpy()
        pt = state.pt.cpu().numpy()
        ps = state.ps.cpu().numpy()
        if not (np.isfinite(q).all() and np.isfinite(pt).all()):
            raise CICheckException("non-finite moist fields")
        if q[..., 0].min() < -1e-6:
            raise CICheckException(f"negative vapor: {q[..., 0].min()}")
        if q[..., 0].max() > 0.06:
            raise CICheckException(f"unphysical vapor: {q[..., 0].max()}")
        if not (ps.min() > 5.0e4 and ps.max() < 1.2e5):
            raise CICheckException(f"unphysical ps: {ps.min()}..{ps.max()}")
        self.archive(env, records)
        return True

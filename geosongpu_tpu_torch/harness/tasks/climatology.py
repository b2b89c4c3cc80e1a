"""HS94 climatology gate (geosongpu_tpu/harness/tasks/climatology.py): a
Validation that fails for physics reasons, not just NaN or mass.

Integrates the dycore with Held-Suarez forcing through baroclinic spin-up,
time-averages the zonal-mean zonal wind, temperature and eddy momentum
flux, and gates on the published Held & Suarez (1994, BAMS 75)
circulation:

  * midlatitude westerly jets aloft (HS94 Fig. 2: ~25-30 m/s near
    sigma ~ 0.25 at |lat| ~ 45 deg at full resolution; the experiment
    scales the floor down for short or coarse runs),
  * tropical near-surface easterlies (u < 0),
  * jet cores off the equator (|lat| > 20 deg),
  * an equator-to-pole temperature gradient of the right sign and size,
  * tropical T at sigma ~ 0.5 (HS94 Fig. 1) and the eddy momentum flux
    peak in the storm-track band (HS94 Fig. 3).

The model runs on the dispatch's device (env "device"), as every task of
the port does; the experiment table's `backend` entry is the original's
and is not read here.  The device it ran on goes into the npz and into
env as "clim.device".
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil

import numpy as np
import torch

from ...device import to_torch
from ..environment import Environment
from ..exceptions import CICheckException
from ..progress import Progress
from ..registry import Registry
from ..task import TaskBase

# the root of the checkout: the parent of the package directory
ROOT = pathlib.Path(__file__).resolve().parents[3]


@Registry.register
class HSClimatology(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        from ...core.config import ExperimentConfig
        from ...dycore.fv_dynamics import exner_mid
        from ...models.held_suarez import build_model

        cfg: ExperimentConfig = env.config
        dyc = cfg.dycore
        device = torch.device(env.get("device", "cuda"))
        model = build_model(dyc, device)
        state = model.init(perturb=0.1)

        # optional committed spun-up state: the spin-up then only
        # re-equilibrates briefly
        init_path = config.get("init_state")
        if init_path:
            full = pathlib.Path(init_path)
            if not full.is_absolute():
                full = ROOT / full
            d = np.load(full)
            if tuple(d["config"][:2]) != (dyc.npx, dyc.npz):
                raise ValueError(f"init_state {init_path} is c{d['config'][0]}"
                                 f"-L{d['config'][1]}, the experiment "
                                 f"c{dyc.npx}-L{dyc.npz}")
            state = dataclasses.replace(
                state, **{k: to_torch(d[k], device)
                          for k in ("u", "v", "delp", "pt")})
            Progress.log(f"HS climatology: resumed from {init_path} "
                         f"({d['note']})")

        steps_per_day = max(1, int(86400.0 / dyc.dt))
        spinup_days = float(config.get("spinup_days", 40.0))
        avg_days = float(config.get("avg_days", 20.0))
        spin_steps = int(spinup_days * steps_per_day)
        avg_steps = int(avg_days * steps_per_day)

        Progress.log(f"HS climatology c{dyc.npx}-L{dyc.npz} on {device}: "
                     f"{spinup_days}+{avg_days} days")
        state = model.run(state, spin_steps)

        # latitude-binned zonal means accumulated over the window
        lat = model.lats.lat_c.cpu().numpy()
        nbins = 24
        edges = np.linspace(-np.pi / 2, np.pi / 2, nbins + 1)
        bin_idx = np.clip(np.digitize(lat.ravel(), edges) - 1, 0, nbins - 1)

        usum = np.zeros((nbins, dyc.npz))
        tsum = np.zeros((nbins, dyc.npz))
        vsum = np.zeros((nbins, dyc.npz))
        uvsum = np.zeros((nbins, dyc.npz))
        nsamp = 0
        sample_every = max(1, steps_per_day // 4)
        while nsamp * sample_every < avg_steps:
            state = model.run(state, sample_every)
            ua = state.ua.cpu().numpy().reshape(-1, dyc.npz)
            va = state.va.cpu().numpy().reshape(-1, dyc.npz)
            tt = (state.pt * exner_mid(state.delp, dyc.ptop)).cpu().numpy(
            ).reshape(-1, dyc.npz)
            for b in range(nbins):
                sel = bin_idx == b
                if sel.any():
                    usum[b] += ua[sel].mean(0)
                    vsum[b] += va[sel].mean(0)
                    # total zonal covariance; the eddy part subtracts the
                    # zonal-mean product at the end
                    uvsum[b] += (ua[sel] * va[sel]).mean(0)
                    tsum[b] += tt[sel].mean(0)
            nsamp += 1
        ubar = usum / max(nsamp, 1)
        tbar = tsum / max(nsamp, 1)
        vbar = vsum / max(nsamp, 1)
        # northward eddy momentum flux u'v' (stationary + transient): the
        # HS94 Fig. 3 statistic
        uv_eddy = uvsum / max(nsamp, 1) - ubar * vbar

        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)
        np.savez_compressed(os.path.join(ws, "hs_climatology.npz"),
                            ubar=ubar, tbar=tbar, vbar=vbar,
                            uv_eddy=uv_eddy, lat_edges=edges,
                            nsamp=nsamp, device=str(device))
        env.set("clim.ubar", ubar)
        env.set("clim.tbar", tbar)
        env.set("clim.uv_eddy", uv_eddy)
        env.set("clim.edges", edges)
        env.set("clim.device", str(device))

    def check(self, config, env: Environment) -> bool:
        ubar = env.get("clim.ubar")
        tbar = env.get("clim.tbar")
        edges = env.get("clim.edges")
        if ubar is None:
            return False
        npz = ubar.shape[1]
        latc = np.degrees(0.5 * (edges[:-1] + edges[1:]))
        upper = slice(0, max(1, int(0.5 * npz)))      # sigma < ~0.5
        surf = slice(npz - max(1, npz // 8), npz)     # lowest ~1/8

        mid = (np.abs(latc) > 25) & (np.abs(latc) < 70)
        trop = np.abs(latc) < 15

        jet = float(ubar[mid][:, upper].max())
        jet_floor = float(config.get("jet_floor_ms", 10.0))
        if jet < jet_floor:
            raise CICheckException(
                f"HS94 gate: midlatitude upper westerlies {jet:.1f} m/s "
                f"< floor {jet_floor} (published ~25-30 at full res)")

        trop_u = float(ubar[trop][:, surf].mean())
        if trop_u > 1.0:
            raise CICheckException(
                f"HS94 gate: tropical surface u {trop_u:.1f} m/s; "
                "expected easterlies (< 0)")

        # jet core off the equator (smoke-size short averages catch
        # transient subtropical phases; experiments can relax it)
        jcol = ubar[:, upper].max(axis=1)
        core_lat = float(abs(latc[int(np.argmax(jcol))]))
        if core_lat < float(config.get("core_lat_min", 20.0)):
            raise CICheckException(
                f"HS94 gate: jet core at |lat|={core_lat:.0f} deg; "
                "published structure has midlatitude cores")

        # equator warmer than poles near the surface, by tens of K
        pole = np.abs(latc) > 60
        dT = float(tbar[trop][:, surf].mean() - tbar[pole][:, surf].mean())
        if not (10.0 < dT < 120.0):
            raise CICheckException(
                f"HS94 gate: equator-pole surface dT {dT:.1f} K outside "
                "(10, 120); forcing profile not being realized")

        # ---- published-statistic gates (Held & Suarez 1994, BAMS 75,
        # Figs. 1-3) ------------------------------------------------------
        k500 = int(round(0.5 * npz - 0.5))  # sigma ~ 0.5 model level
        eq = np.abs(latc) < 10.0
        t500 = float(tbar[eq][:, k500].mean())
        t_lo, t_hi = config.get("t500_range", (248.0, 285.0))
        if not (t_lo < t500 < t_hi):
            raise CICheckException(
                f"HS94 gate: tropical T at sigma~0.5 is {t500:.1f} K, "
                f"outside [{t_lo}, {t_hi}] (HS94 Fig. 1: ~260-270 K)")

        uv_eddy = env.get("clim.uv_eddy")
        if uv_eddy is not None and config.get("eddy_gate", True):
            upper_k = slice(0, max(1, npz // 2))
            nh = latc > 10.0
            # peak northward flux in the NH upper troposphere
            peak = float(uv_eddy[nh][:, upper_k].max())
            peak_floor = float(config.get("eddy_flux_floor", 2.0))
            if peak < peak_floor:
                raise CICheckException(
                    f"HS94 gate: NH upper-level eddy momentum flux peak "
                    f"{peak:.1f} m2/s2 < {peak_floor} (HS94 Fig. 3: "
                    "~50-80 at full resolution; absence = no baroclinic "
                    "eddies)")
            blat = float(latc[nh][int(np.argmax(
                uv_eddy[nh][:, upper_k].max(axis=1)))])
            if not (10.0 < blat < 70.0):
                raise CICheckException(
                    f"HS94 gate: eddy flux peak at {blat:.0f} deg N, "
                    "outside the 10-70 deg storm-track band")

        Progress.log(f"HS94 climatology gates: jet {jet:.1f} m/s @ "
                     f"|lat|~{core_lat:.0f}, tropical surface u "
                     f"{trop_u:.1f} m/s, dT {dT:.1f} K -> OK")
        os.makedirs(env.artifact_directory, exist_ok=True)
        src = os.path.join(env.CI_WORKSPACE, "hs_climatology.npz")
        dst = os.path.join(env.artifact_directory, "hs_climatology.npz")
        if os.path.exists(src) and not (os.path.exists(dst)
                                        and os.path.samefile(src, dst)):
            shutil.copy(src, dst)
        return True

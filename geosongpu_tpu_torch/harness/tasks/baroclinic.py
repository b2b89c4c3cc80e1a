"""Jablonowski-Williamson (2006) baroclinic-wave validation task
(geosongpu_tpu/harness/tasks/baroclinic.py).

The gates cite Jablonowski & Williamson (2006), Q. J. R. Meteorol. Soc.
132, 2943-2975 (JW06), a published deterministic test case.  Two
sub-experiments in one Validation action, on the port's JW06 model:

1. steady state (JW06 section 3): the unperturbed balanced zonal state
   must hold, surface pressure near 1000 hPa;
2. baroclinic wave (JW06 section 4): with the Gaussian u perturbation the
   wave grows on the published schedule (JW06 Figs. 4-6): ps_min nearly
   unchanged through day 4, explosive deepening days 7-10, the low in the
   northern midlatitudes.

The model runs on the dispatch's device (env "device").  The npz of
results is written to the workspace and copied to the artifact directory
when that is another directory.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ..environment import Environment
from ..exceptions import CICheckException
from ..progress import Progress
from ..registry import Registry
from ..task import TaskBase


@Registry.register
class BaroclinicWave(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        from ...core.config import ExperimentConfig
        from ...models.baroclinic_wave import build_model

        cfg: ExperimentConfig = env.config
        dyc = cfg.dycore
        model = build_model(dyc, env.get("device", "cuda"))
        steps_per_day = max(1, int(round(86400.0 / dyc.dt)))

        steady_days = int(config.get("steady_days", 4))
        wave_days = int(config.get("wave_days", 10))

        Progress.log(f"JW06 c{dyc.npx}-L{dyc.npz} on {model.device}: steady "
                     f"{steady_days}d + wave {wave_days}d")
        s = model.init(perturb=False)
        s = model.run(s, steady_days * steps_per_day)
        ps = s.ps.cpu().numpy()
        env.set("jw.steady_ps_dev", float(np.abs(ps - 1.0e5).max()))
        env.set("jw.steady_umax", float(s.u.abs().max()))

        s = model.init(perturb=True)
        mins = []
        for d in range(wave_days):
            s = model.run(s, steps_per_day)
            mins.append(float(s.ps.min()))
            if not np.isfinite(mins[-1]):
                raise CICheckException(f"non-finite ps at day {d + 1}")
        env.set("jw.ps_min_by_day", mins)
        # latitude of the deepest low at the end (storm track band gate)
        psf = s.ps.cpu().numpy()
        h = model.grid.h
        n = dyc.npx
        lat = np.degrees(np.asarray(model.grid.lat)[:, h:h + n, h:h + n])
        env.set("jw.low_lat", float(lat.ravel()[np.argmin(psf.ravel())]))

        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)
        np.savez_compressed(
            os.path.join(ws, "jw_baroclinic.npz"),
            ps_min_by_day=np.asarray(mins),
            ps_final=psf,
            steady_ps_dev=env.get("jw.steady_ps_dev"))

    def check(self, config, env: Environment) -> bool:
        dev = env.get("jw.steady_ps_dev")
        mins = env.get("jw.ps_min_by_day")
        if dev is None or mins is None:
            return False
        # 1. steady state holds (JW06 sec. 3); the cap is the experiment's
        cap = float(config.get("steady_ps_cap_pa", 1500.0))
        if dev > cap:
            raise CICheckException(
                f"JW06 steady state broke: max |ps - p0| = {dev:.0f} Pa "
                f"> {cap:.0f} (JW06 Fig. 3: the balanced state holds)")
        # 2. quiet through day 4 (JW06 Fig. 4: the perturbation stays
        # weak; ps_min > ~990 hPa)
        if mins[3] < 98600.0:
            raise CICheckException(
                f"JW06 wave grew too fast: day-4 ps_min {mins[3]:.0f} Pa "
                "< 98600 (JW06 Fig. 4: near-unchanged through day 4)")
        # 3. explosive deepening by day `deep_day` (JW06 Figs. 5-6:
        # 930-970 hPa at day 9 at ~1.25-2.8 deg; coarse grids deepen
        # later - the experiment sets the day and the cap)
        deep_day = int(config.get("deep_day", 9))
        deep_cap = float(config.get("deep_cap_pa", 99000.0))
        got = mins[deep_day - 1]
        if got > deep_cap:
            raise CICheckException(
                f"JW06 wave failed to deepen: day-{deep_day} ps_min "
                f"{got:.0f} Pa > {deep_cap:.0f} (JW06 Fig. 5: explosive "
                "growth days 7-10, ps_min ~930-970 hPa by day 9)")
        if got < 90000.0:
            raise CICheckException(
                f"JW06 wave over-deepened: {got:.0f} Pa (< 900 hPa is "
                "outside anything JW06 shows)")
        low_lat = env.get("jw.low_lat")
        if low_lat is not None and not (20.0 < low_lat < 80.0):
            raise CICheckException(
                f"JW06 low at lat {low_lat:.0f}; the wave train belongs "
                "in the northern midlatitudes (JW06 Fig. 6)")
        Progress.log(
            f"JW06 gates: steady dev {dev:.0f} Pa, day-4 min "
            f"{mins[3]:.0f}, day-{deep_day} min {got:.0f} Pa at lat "
            f"{low_lat:.0f}N -> OK")
        os.makedirs(env.artifact_directory, exist_ok=True)
        src = os.path.join(env.CI_WORKSPACE, "jw_baroclinic.npz")
        dst = os.path.join(env.artifact_directory, "jw_baroclinic.npz")
        if os.path.exists(src) and not (os.path.exists(dst)
                                        and os.path.samefile(src, dst)):
            shutil.copy(src, dst)
        return True

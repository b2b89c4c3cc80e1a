"""Scaling-efficiency and transport benchmark task
(geosongpu_tpu/harness/tasks/scaling.py).

* ring-permute bandwidth and sum latency (parallel/mesh.comm_microbench,
  the OSU rows) over the real ranks: the initialised process group, or
  this process alone, where the ring is a loopback copy;
* a weak-scaling sweep of the Held-Suarez step over subtile layouts at a
  fixed Courant number (dt scales with 1/npx, so the work per point and
  the stability margin stay the same across the sweep), on 1 rank and on
  the process group's ranks (2, 4 or 8);
* per multi-rank entry the halo/compute overlap fraction: t_comm (the
  exchange rounds alone), t_compute (the same step with the rounds
  skipped, comm=False), t_step, overlap = (t_comm + t_compute - t_step) /
  t_comm, unclipped.  The port's rank groups exchange synchronously, so
  nothing overlaps: the fraction reads about 0, and below 0 where the
  step's exchanges cost more than the comm-only leg's.  The reference's
  rim-split legs are not run (rim_split runs the unsplit c_sw here).

The ranks are real: stacked ranks share one device, so their times are not
scaling.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from ...core.config import DycoreConfig
from ...device import synchronize
from ..environment import Environment
from ..progress import Progress
from ..registry import Registry
from ..task import TaskBase


def _near_square(m: int):
    ys = int(np.sqrt(m))
    while m % ys:
        ys -= 1
    return ys, m // ys


def _time_fn(fn, arg, device, repeats=3):
    fn(arg)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(arg)
    synchronize(device)
    return (time.perf_counter() - t0) / repeats


@Registry.register
class ScalingBench(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        from ...models.held_suarez import build_model
        from ...parallel.comm import ProcessGroup, StackedGroup
        from ...parallel.mesh import comm_microbench
        from ...parallel.subtile import (SubtileFiller, SubtileLayout,
                                         build_subtile_plan,
                                         build_subtile_step)

        device = torch.device(env.get("device", "cuda"))
        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)
        world = (ProcessGroup(device) if torch.distributed.is_initialized()
                 else StackedGroup(1, device))
        results = {"device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                   "n_devices": world.size,
                   "comm": comm_microbench(world, repeats=10)}

        # ---- weak scaling over subtile layouts -------------------------
        # per-rank block ~B x B cells; dt ~ 1/npx holds the Courant number
        B, npx0, dt0 = 12, 12, 600.0
        sizes = [nd for nd in (1, 2, 4, 8) if nd == 1 or nd == world.size]
        scaling = []
        for nd in sizes:
            group = world if nd > 1 else StackedGroup(1, device)
            py, px = _near_square(nd)
            lcm = int(np.lcm(py, px))
            npx = int(round(B * np.sqrt(nd) / lcm)) * lcm  # divisibility
            cfg = DycoreConfig(npx=npx, npz=16, dt=dt0 * npx0 / npx,
                               n_split=3, overlap_fills=True)
            model = build_model(cfg, device)
            st = model.init(perturb=1e-3)
            lay = SubtileLayout(n=npx, h=cfg.halo, py=py, px=px,
                                face_sharded=False)

            def leg(m, comm=True):
                step, place, _ = build_subtile_step(
                    m.ctx, lay, group, lats=m.lats, forcing=m.forcing,
                    comm=comm)
                return _time_fn(step, place(st), device)

            t_step = leg(model)
            entry = {"n_devices": nd, "layout": [py, px], "npx": npx,
                     "dt": cfg.dt, "step_s": t_step,
                     "gridpoints_per_s": cfg.grid_points / t_step}
            if nd > 1:
                # compute-only: the same program with the rounds skipped
                t_compute = leg(model, comm=False)
                # comm-only: the exchange rounds at one substep's volumes,
                # n_split times (+1 for the remap/tracer fills)
                filler = SubtileFiller(build_subtile_plan(
                    lay.n, lay.h, lay.py, lay.px, lay.face_sharded), group)
                placed = build_subtile_step(model.ctx, lay, group)[1](st)

                def comm_only(s):
                    acc = torch.zeros((), device=device)
                    for i in range(cfg.n_split + 1):
                        pu, pv = filler.fill_dgrid(s.u + i, s.v)
                        acc = acc + pu.sum() + pv.sum()
                        acc = acc + filler.fill(s.delp + i, "x").sum()
                        acc = acc + filler.fill(s.pt + i, "x").sum()
                    return acc

                t_comm = _time_fn(comm_only, placed, device)
                overlap = (t_comm + t_compute - t_step) / max(t_comm, 1e-12)
                entry.update(comm_s=t_comm, compute_s=t_compute,
                             overlap_frac=float(overlap))
            scaling.append(entry)

        # weak-scaling efficiency: per-rank throughput against 1 rank
        base = scaling[0]["gridpoints_per_s"]
        for entry in scaling:
            entry["efficiency"] = (entry["gridpoints_per_s"]
                                   / (base * entry["n_devices"]))
        results["weak_scaling"] = scaling

        with open(os.path.join(ws, "scaling_bench.json"), "w") as f:
            json.dump(results, f, indent=2)
        env.set("scaling.results", results)
        for entry in scaling:
            ov = entry.get("overlap_frac")
            Progress.log(
                f"{entry['n_devices']} rank(s) {tuple(entry['layout'])}: "
                f"c{entry['npx']} {entry['step_s'] * 1e3:.1f} ms/step, "
                f"eff {entry['efficiency'] * 100:.0f}%"
                + (f", overlap {ov * 100:.0f}%" if ov is not None else ""))

    def check(self, config, env: Environment) -> bool:
        results = env.get("scaling.results")
        if not results:
            return False
        os.makedirs(env.artifact_directory, exist_ok=True)
        shutil.copy(os.path.join(env.CI_WORKSPACE, "scaling_bench.json"),
                    os.path.join(env.artifact_directory,
                                 "scaling_bench.json"))
        sc = results.get("weak_scaling", [])
        ok = bool(sc) and all(np.isfinite(e["step_s"]) and e["step_s"] > 0
                              for e in sc)
        # every multi-rank entry must report its overlap fraction
        ok = ok and all("overlap_frac" in e for e in sc
                        if e["n_devices"] > 1)
        comm = results.get("comm", {})
        return ok and all(np.isfinite(g) and g > 0
                          for g in comm.get("ppermute_gbps", [0.0]))

"""Held-Suarez pipeline task, the flagship workload
(geosongpu_tpu/harness/tasks/held_suarez.py).

build -> init -> warm-up (the first step builds the kernels) -> timed
steps -> a structured benchmark record and the validation gates, on the
dispatch's device (env "device").

  Validation / All : one gated run at the experiment's configuration
  Benchmark        : the pair eager PyTorch substep vs fused CUDA kernels
                     (pallas_dycore=True), each with a measured phase tree,
                     and a round-over-round comparison against the
                     benchmark records already in the artifact directory

A record's extra holds the mesh description, the launches of each kernel
over the run (its steps and its tree) and, with a tree, the form its
"vertical remap" leaf timed.

The port runs on one device.  An experiment that declares a mesh of more
devices than the host has runs single-device and says so in the record
(the original's own branch for such a layout); the sharded path of a mesh
the host could hold is not ported (ROADMAP A.13) and is refused.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import time

import numpy as np
import torch

from ...benchmark.phases import measure_phases, remap_leaf
from ...benchmark.timing import BenchmarkRecord, StepTimer, report
from ...core.config import DycoreConfig, ExperimentConfig, MeshConfig
from ...device import synchronize, to_torch
from ...ops.kernels import launch_counts
from ...ops.remap import remap_field, remap_field_banded
from ...ops.vertical import interfaces_from_delp
from ..environment import Environment
from ..exceptions import CICheckException
from ..progress import Progress
from ..registry import Registry
from ..task import PipelineAction, TaskBase

PHASE_INNER = 10   # calls a block of the phase tree's timing


def mesh_description(mesh: MeshConfig, device: torch.device) -> str:
    """The record's "mesh" entry for a run on `device`: "single-device",
    or the original's string for a declared layout larger than the host.
    Raises NotImplementedError for a layout the host could hold."""
    if mesh is None or mesh.n_devices <= 1:
        return "single-device"
    available = torch.cuda.device_count() if device.type == "cuda" else 1
    if available >= mesh.n_devices:
        raise NotImplementedError(
            f"mesh of {mesh.n_devices} devices on a host with {available}: "
            "the sharded path is not ported (ROADMAP A.13)")
    return (f"single-device (mesh {mesh.n_devices} devices declared, "
            f"{available} available)")


@Registry.register
class HeldSuarez(TaskBase):
    key = "hs"                                # prefix of the env keys
    fused = {"pallas_dycore": True}           # the Benchmark's fused member
    fields = ("u", "v", "delp", "pt", "ps")   # in state_{experiment}.npz

    def build_model(self, dyc: DycoreConfig, device):
        from ...models.held_suarez import build_model

        return build_model(dyc, device)

    def phase_forcing(self, model, state):
        """forcing_fn of the phase tree; None: Held-Suarez forcing."""
        return None

    # ------------------------------------------------------------------
    def _timed_run(self, env: Environment, dyc: DycoreConfig,
                   backend_name: str, steps: int, warmup: int,
                   with_phases: bool = False, mesh=None):
        """One measured run -> (BenchmarkRecord, final state, model)."""
        if env.get("HARDWARE_SAMPLING") in ("1", "true", "True"):
            raise NotImplementedError(
                "HARDWARE_SAMPLING: the hardware sampler and energy "
                "envelope (hws) are not ported yet (ROADMAP A.12)")
        device = torch.device(env.get("device", "cuda"))
        mesh_desc = mesh_description(mesh, device)
        before = launch_counts()
        model = self.build_model(dyc, device)
        rec = BenchmarkRecord(
            experiment=env.experiment_name,
            backend=backend_name,
            grid={"npx": dyc.npx, "npz": dyc.npz},
        )
        rec.extra["mesh"] = mesh_desc

        t0 = time.perf_counter()
        state = model.init(perturb=1e-3)
        synchronize(device)
        rec.setup_time_s = time.perf_counter() - t0

        # warm-up: the first step builds the kernels
        t0 = time.perf_counter()
        for _ in range(max(1, warmup)):
            state = model.step(state)
        synchronize(device)
        rec.compile_time_s = time.perf_counter() - t0

        timer = StepTimer()
        for _ in range(steps):
            timer.start()
            state = model.step(state)
            synchronize(device)
            timer.stop()
        rec.step_time_s = timer.times

        if with_phases:
            rec.phase_tree = measure_phases(
                model, state, inner=PHASE_INNER,
                forcing_fn=self.phase_forcing(model, state)).to_dict()
            rec.extra["remap_leaf"] = remap_leaf(dyc)
        # the kernels this run launched (steps and tree), by name
        rec.extra["launches"] = {k: n - before[k]
                                 for k, n in launch_counts().items()
                                 if n > before[k]}
        return rec, state, model

    # ------------------------------------------------------------------
    def run_action(self, config, env: Environment) -> None:
        cfg: ExperimentConfig = env.config
        if cfg is None:
            raise ValueError(f"experiment {env.experiment_name} has no "
                             "experiment configuration")
        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)
        hw = torch.device(env.get("device", "cuda")).type

        if env.experiment_action == PipelineAction.Benchmark:
            records = []
            pairs = [("eager", cfg.dycore),
                     ("fused", dataclasses.replace(cfg.dycore, **self.fused))]
            for name, dyc in pairs:
                rec, state, model = self._timed_run(
                    env, dyc, f"{hw}:{name}", cfg.run.steps,
                    cfg.run.warmup_steps, with_phases=True, mesh=cfg.mesh)
                rec.save(os.path.join(
                    ws, f"benchmark_{env.experiment_name}_{name}.json"))
                records.append(rec)
        else:
            rec, state, model = self._timed_run(
                env, cfg.dycore, hw, cfg.run.steps, cfg.run.warmup_steps,
                mesh=cfg.mesh)
            rec.save(os.path.join(ws, f"benchmark_{env.experiment_name}.json"))
            records = [rec]

        np.savez_compressed(
            os.path.join(ws, f"state_{env.experiment_name}.npz"),
            **{k: getattr(state, k).cpu().numpy() for k in self.fields})
        env.set(f"{self.key}.records", records)
        env.set(f"{self.key}.record", records[-1])
        env.set(f"{self.key}.final_state", state)
        env.set(f"{self.key}.model", model)

    # ------------------------------------------------------------------
    def check(self, config, env: Environment) -> bool:
        state = env.get("hs.final_state")
        records = env.get("hs.records")
        model = env.get("hs.model")
        if state is None or not records:
            return False

        u = state.u.cpu().numpy()
        pt = state.pt.cpu().numpy()
        ps = state.ps.cpu().numpy()
        if not (np.isfinite(u).all() and np.isfinite(pt).all()):
            raise CICheckException("non-finite fields after run")
        if not (ps.min() > 5.0e4 and ps.max() < 1.2e5):
            raise CICheckException(f"unphysical ps range: {ps.min()}..{ps.max()}")
        w = np.asarray(model.grid.area)[model.grid.interior][..., None]
        mass = float((w * state.delp.cpu().numpy()).sum())
        mass0 = float(w.sum() * (1.0e5 - model.config.ptop))
        if abs(mass - mass0) / mass0 > 1e-3:
            raise CICheckException(f"mass drift {abs(mass-mass0)/mass0:.2e}")
        if model.config.remap_band > 0:
            check_banded_remap(model, state)

        self.archive(env, records)
        return True

    def archive(self, env: Environment, records) -> None:
        """Write the report over this run's records and the benchmark
        records already in the artifact directory (the previous round), and
        save this run's records there."""
        all_records = list(records)
        for path in sorted(glob.glob(os.path.join(
                env.artifact_directory,
                f"benchmark_{env.experiment_name}*.json"))):
            try:
                prev = BenchmarkRecord.load(path)
            except (OSError, ValueError, TypeError) as e:
                Progress.log(f"skipping unreadable benchmark record {path}: "
                             f"{e}")
                continue
            prev.experiment += " (prev round)"
            all_records.append(prev)

        os.makedirs(env.artifact_directory, exist_ok=True)
        rep = report(all_records)
        with open(os.path.join(env.artifact_directory,
                               "report_benchmark.out"), "w") as f:
            f.write(rep + "\n")
        for rec in records:
            rec.save(os.path.join(
                env.artifact_directory,
                f"benchmark_{env.experiment_name}_{rec.backend}.json"))
        Progress.log(rep)


def check_banded_remap(model, state) -> None:
    """The two gates of the banded remap's assumption, every run:

    1. the measured Lagrangian deformation |omga| dt / delp (the interface
       displacement in layers over a step) stays below remap_band/2;
    2. banded == full on a coordinate displaced by up to remap_band/2
       layers (a smooth sinusoidal displacement, zero at the ends, halved
       until the displaced interfaces stay monotone), on the final pt.
    Both forms are the plain PyTorch ones, computed a face at a time."""
    cfg = model.config
    delp = state.delp
    disp = float((state.omga.abs() * cfg.dt
                  / torch.clamp(delp, min=1.0)).max())
    if disp > 0.5 * cfg.remap_band:
        raise CICheckException(
            f"Lagrangian deformation {disp:.2f} layers exceeds "
            f"remap_band/2 = {0.5 * cfg.remap_band}: banded "
            "remap exactness no longer guaranteed")
    pe1 = interfaces_from_delp(delp, cfg.ptop)
    pe2 = model.ctx.ak + model.ctx.bk * pe1[..., -1:]
    K1 = delp.shape[-1]
    dp2 = pe2[..., 1:] - pe2[..., :-1]
    thick = torch.cat([dp2[..., :1], 0.5 * (dp2[..., 1:] + dp2[..., :-1]),
                       dp2[..., -1:]], dim=-1)
    prof = to_torch(np.sin(np.pi * np.arange(K1 + 1) / K1), delp.device)
    amp = 0.5 * cfg.remap_band
    while amp > 0.25:
        pe1_t = pe2 + amp * prof * thick
        if float((pe1_t[..., 1:] - pe1_t[..., :-1]).min()) > 0:
            break
        amp *= 0.5
    d = sc = 0.0
    for f in range(delp.shape[0]):
        a = (state.pt[f], pe1_t[f], pe2[f])
        full = remap_field(*a, cfg.kord)
        band = remap_field_banded(*a, cfg.kord, band=cfg.remap_band)
        d = max(d, float((full - band).abs().max()))
        sc = max(sc, float(full.abs().max()))
    if d > 1e-5 * sc:
        raise CICheckException(
            f"banded remap diverged from exact by {d/sc:.2e} on "
            f"a {amp}-layer-displaced coordinate (remap_band="
            f"{cfg.remap_band})")

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

With HARDWARE_SAMPLING set, the run is sampled (hws.server.Sampler, one
sample after each timed step) and the record's energy filled: `tpu_kwh` is
the card's energy counter over the timed steps (0 on the CPU), `cpu_kwh`
the host model's integral over the samples' times.

An experiment's declared mesh runs sharded (parallel/subtile.py
build_mesh_stepper): over the ranks of an initialised process group, or,
with env "stacked_ranks" set, over all ranks of the layout stacked in this
process on the one device.  A layout larger than the host's real ranks
runs single-device and says so in the record, as the original does.  The
gates run on the unplaced global state; a sharded run has no phase tree.
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
from ...core.config import DycoreConfig, ExperimentConfig
from ...device import synchronize, to_torch
from ...hws.analysis import energy_envelope, load_data
from ...hws.server import Sampler
from ...ops.kernels import launch_counts
from ...ops.remap import remap_field, remap_field_banded
from ...ops.vertical import interfaces_from_delp
from ...parallel.subtile import build_mesh_stepper
from ..environment import Environment
from ..exceptions import CICheckException
from ..progress import Progress
from ..registry import Registry
from ..task import PipelineAction, TaskBase

PHASE_INNER = 10   # calls a block of the phase tree's timing
STACKED = ("1", "true", "True", True)   # values of env "stacked_ranks"


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
        device = torch.device(env.get("device", "cuda"))
        sampler = None
        if env.get("HARDWARE_SAMPLING") in ("1", "true", "True"):
            sampler = Sampler(rate_s=0.1, device=device)
        try:
            return self._measure(env, dyc, backend_name, steps, warmup,
                                 with_phases, device, mesh, sampler)
        finally:
            if sampler is not None:
                sampler.close()

    def _measure(self, env, dyc, backend_name, steps, warmup, with_phases,
                 device, mesh, sampler):
        before = launch_counts()
        model = self.build_model(dyc, device)
        place, step, unplace, mesh_desc = build_mesh_stepper(
            model, mesh, stacked=env.get("stacked_ranks") in STACKED)
        rec = BenchmarkRecord(
            experiment=env.experiment_name,
            backend=backend_name,
            grid={"npx": dyc.npx, "npz": dyc.npz},
        )
        rec.extra["mesh"] = mesh_desc

        t0 = time.perf_counter()
        state = place(model.init(perturb=1e-3))
        synchronize(device)
        rec.setup_time_s = time.perf_counter() - t0

        # warm-up: the first step builds the kernels
        t0 = time.perf_counter()
        for _ in range(max(1, warmup)):
            state = step(state)
        synchronize(device)
        rec.compile_time_s = time.perf_counter() - t0

        timer = StepTimer()
        start = sampler.read_counter() if sampler is not None else None
        for _ in range(steps):
            timer.start()
            state = step(state)
            synchronize(device)
            timer.stop()
            if sampler is not None:
                # after stop(): the sample's reads (NVML, /proc) stay out
                # of the step's time; it reads the counter first
                sampler.sample_once()
        rec.step_time_s = timer.times
        if sampler is not None:
            fill_energy(rec, sampler, start, os.path.join(
                env.CI_WORKSPACE, "hws_" + backend_name.replace(":", "_")))

        state = unplace(state)   # the global state, for gates and archives
        if with_phases and mesh_desc.startswith("single-device"):
            rec.phase_tree = measure_phases(
                model, state, inner=PHASE_INNER,
                forcing_fn=self.phase_forcing(model, state)).to_dict()
            rec.extra["remap_leaf"] = remap_leaf(dyc)
        elif with_phases:
            # the phase tree instruments the single-device model's
            # functions; a sharded run keeps the whole-step times
            rec.extra["phases_note"] = ("sharded run: per-phase tree not "
                                        "instrumented, whole-step times only")
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


def fill_energy(rec: BenchmarkRecord, sampler: Sampler, start,
                dump_dir: str) -> None:
    """Dump the samples to dump_dir and fill the record's energy (the
    original's keys) and its extra: the card's energy over the timed
    window from its counter (`start`: the counter before the first timed
    step; the last sample read it just after the last synchronisation),
    beside the trapezoid of the sampled power, which lags the load (NVML
    averages it over about a second)."""
    dump = sampler.dump(dump_dir)
    er = energy_envelope(load_data(dump))
    (t0, e0), (t1, e1) = start, sampler.last_counter
    gpu_j = (e1 - e0) / 1e3 if e0 is not None else 0.0
    window = t1 - t0
    rec.energy = {"cpu_kwh": er.cpu_kwh, "tpu_kwh": gpu_j / 3.6e6,
                  "total_kwh": er.cpu_kwh + gpu_j / 3.6e6}
    rec.extra.update(
        hws_dump=dump, gpu_energy_j_counter=gpu_j,
        gpu_energy_j_samples=er.tpu_joules, window_s=window,
        mean_gpu_power_w=gpu_j / window if window > 0 else 0.0,
        j_per_step=gpu_j / len(rec.step_time_s))


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

"""Command line: run a model of the port, or its physics gate.

    python -m geosongpu_tpu_torch.cli run [--preset NAME]
        [--npx N --npz K] --steps S [--device cuda|cpu]
    python -m geosongpu_tpu_torch.cli physics [--kernel NAME|all]
        [--device cuda|cpu]
    python -m geosongpu_tpu_torch.cli ci EXPERIMENT [ACTION]
        [--artifact DIR] [--workspace DIR] [--setup_only]
        [--device cuda|cpu]

`run` steps the preset's model, Held-Suarez, aquaplanet or the JW06
baroclinic wave.  `ci` dispatches an experiment of the port's harness
(harness/data/experiments.json) to its tasks and exits with an error when
a task's check fails.  The experiments are the reference's:

* `held_suarez_c12`, `_c24`, `_c48`, `_c192` and `_c16_sharded` (the
  HeldSuarez task; a declared mesh larger than the host runs on one
  device), `aquaplanet_c24` and `aquaplanet_c48` (Aquaplanet): Validation
  gates one run; Benchmark times the eager substep against the fused
  kernels, each with its measured phase tree, and writes the records and
  `report_benchmark.out` to the artifact directory;
  `held_suarez_bench_smoke` and `aquaplanet_bench_smoke` are the same at
  c8-L6, seconds on the CPU;
* `hs_climatology`, `_smoke` and `_full` (HSClimatology, the Held-Suarez
  1994 circulation gates; the first two run on the CPU as their entry's
  `backend` says);
* `physics_standalone_<kernel>` and `physics_standalone_all` (the seven
  standalone physics tasks, the gate below as pipeline tasks);
* `jw_baroclinic_c48`, `_c48_fused` and `_smoke` (BaroclinicWave).

`physics` runs
the dual-build gate of the standalone physics kernels
(physics/standalone_gate.py): each primary against its hand-written kernel
over five datasets, relative RMS <= 1e-4 per variable; it exits with 1 on
a miss.

The Held-Suarez presets have 72 levels, dt 600 s and hord_tm 6, the
configuration of the repository's headline benchmark (bench.py) and of the
rungs of scripts/bench_ladder.py; n_split is 6 except at c192:

* `held_suarez_c48_l72_fused`: c48, the fused substep (pallas_dycore=True;
  CUDA kernels dsw_csw1, dsw_csw2, dsw_transport, dsw_wind and
  dsw_tracer_acc), the exchange damping form;
* `held_suarez_c48_l72`: the same with the eager PyTorch substep;
* `held_suarez_c192_l72_fused`: c192, the fused substep with the blend
  damping form (dsw_wind computes the damping divergence itself), and
  n_split 8: with the ladder's n_split 6 the acoustic substep of 100 s
  exceeds the horizontal stability limit of the c192 grid, and the model,
  like the JAX package's, goes non-finite in its sixth step;
* `held_suarez_c48_l72_nh_fused`: c48 nonhydrostatic with per-substep
  tracers (hydrostatic=False, z_tracer=False): dsw_transport carries w and
  delz, dsw_tracer runs once per tracer and substep, the implicit vertical
  solve follows, and dsw_wind takes the p', phi' and rho of dsw_nh_pert.

The aquaplanet presets are the `aquaplanet_c48` experiment of the harness
(c48, 32 levels, dt 600 s, n_split 6, the tracers qv, ql and qr), as the
pair its Benchmark action times:

* `aquaplanet_c48_l32_fused`: pallas_dycore=True and
  pallas_microphysics=True: the fused substep, dsw_tracer_acc for each of
  the three tracers, and the CUDA kernels fill_q2_zero (the three tracers
  in one launch a step), cup_gf_sh and gfdl_microphysics;
* `aquaplanet_c48_l32`: both flags off, everything in plain PyTorch but
  the banded remap.

`jw_baroclinic_c48_l26_fused` is the `jw_baroclinic_c48_fused` experiment
of the harness: the JW06 baroclinic wave at c48-L26, dt 600 s, n_split 6,
no tracers, with its balancing terrain, through the fused substep
(dsw_csw1, dsw_csw2, dsw_transport, dsw_wind and remap_banded).

CUDA is required unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from .core.config import DycoreConfig

_HS72 = dict(npz=72, dt=600.0, n_split=6, hord_tm=6)
_AQ32 = dict(npx=48, npz=32, dt=600.0, n_split=6, ntracers=3)
PRESETS = {
    "held_suarez_c48_l72": DycoreConfig(npx=48, pallas_dycore=False, **_HS72),
    "held_suarez_c48_l72_fused": DycoreConfig(npx=48, pallas_dycore=True,
                                              **_HS72),
    "held_suarez_c192_l72_fused": DycoreConfig(
        npx=192, pallas_dycore=True, **{**_HS72, "n_split": 8}),
    "held_suarez_c48_l72_nh_fused": DycoreConfig(
        npx=48, pallas_dycore=True, hydrostatic=False, z_tracer=False,
        **_HS72),
    "aquaplanet_c48_l32": DycoreConfig(**_AQ32),
    "aquaplanet_c48_l32_fused": DycoreConfig(
        pallas_dycore=True, pallas_microphysics=True, **_AQ32),
    "jw_baroclinic_c48_l26_fused": DycoreConfig(
        npx=48, npz=26, dt=600.0, n_split=6, ntracers=0, pallas_dycore=True),
}
# preset -> model ("held_suarez" unless named here)
MODELS = {"aquaplanet_c48_l32": "aquaplanet",
          "aquaplanet_c48_l32_fused": "aquaplanet",
          "jw_baroclinic_c48_l26_fused": "baroclinic_wave"}


def build_model_for(preset: str):
    """build_model(config, device) of the preset's model."""
    if MODELS.get(preset) == "aquaplanet":
        from .models.aquaplanet import build_model
    elif MODELS.get(preset) == "baroclinic_wave":
        from .models.baroclinic_wave import build_model
    else:
        from .models.held_suarez import build_model
    return build_model


def _physics(kernel: str, device) -> int:
    from .physics import standalone_gate as gate

    names = sorted(gate.KERNELS) if kernel == "all" else [kernel]
    missed = 0
    for name in names:
        try:
            worst = gate.run_gate(name, device)
        except gate.GateMiss as e:
            print(f"{name}: MISSED: {e}")
            missed += 1
        else:
            print(f"{name}: {gate.N_DATASETS} datasets within "
                  f"{gate.REL_TOL:.0e} (worst rel RMS {worst:.3e})")
    return 1 if missed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="geosongpu-tpu-torch",
        description="Held-Suarez, aquaplanet and JW06 models, the CI "
                    "experiments and the physics gate of the PyTorch/CUDA "
                    "port")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run a preset's model (Held-Suarez, "
                                     "aquaplanet or JW06)")
    run.add_argument("--preset", default="held_suarez_c48_l72",
                     choices=sorted(PRESETS))
    run.add_argument("--npx", type=int, default=None)
    run.add_argument("--npz", type=int, default=None)
    run.add_argument("--steps", type=int, default=8)
    phys = sub.add_parser("physics", help="the dual-build gate of the "
                                          "standalone physics kernels")
    phys.add_argument("--kernel", default="all")
    ci = sub.add_parser("ci", help="dispatch an experiment of the harness")
    ci.add_argument("experiment_name")
    ci.add_argument("experiment_action", nargs="?", default="All",
                    choices=["All", "Validation", "Benchmark"])
    ci.add_argument("--artifact", default=".", help="artifact directory")
    ci.add_argument("--setup_only", action="store_true")
    ci.add_argument("--workspace", default=None,
                    help="CI_WORKSPACE (default: that environment variable, "
                         "else ./.ci_workspace)")
    for sp in (run, phys, ci):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch

    from .device import synchronize

    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("CUDA is not available; pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    if args.cmd == "ci":
        from .harness.task import dispatch

        ws = args.workspace or os.environ.get(
            "CI_WORKSPACE", os.path.join(os.getcwd(), ".ci_workspace"))
        dispatch(args.experiment_name, args.experiment_action,
                 artifact_directory=args.artifact,
                 setup_only=args.setup_only, workspace=ws, device=args.device)
        return 0
    if args.cmd == "physics":
        from .physics.standalone_gate import KERNELS

        if args.kernel != "all" and args.kernel not in KERNELS:
            p.error(f"--kernel: one of all, {', '.join(sorted(KERNELS))}")
        return _physics(args.kernel, device)

    cfg = PRESETS[args.preset]
    if args.npx is not None:
        cfg = dataclasses.replace(cfg, npx=args.npx)
    if args.npz is not None:
        cfg = dataclasses.replace(cfg, npz=args.npz)

    model = build_model_for(args.preset)(cfg, device)
    state = model.init(perturb=1e-3)
    t0 = time.perf_counter()
    state = model.step(state)   # warm-up: kernel build, allocator
    synchronize(device)
    print(f"first step: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    state = model.run(state, args.steps)
    synchronize(device)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"c{cfg.npx}-L{cfg.npz} on {where}: {args.steps} steps in "
          f"{dt:.3f} s ({dt / args.steps * 1e3:.2f} ms/step); "
          f"ps range {float(state.ps.min()):.0f}..{float(state.ps.max()):.0f}"
          f" Pa; max|u| {float(state.u.abs().max()):.2f} m/s"
          + (f"; mean qv {float(state.q[..., 0].mean()):.3e} kg/kg"
             if MODELS.get(args.preset) == "aquaplanet" else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command line: run the Held-Suarez model on the port.

    python -m geosongpu_tpu_torch.cli run [--preset NAME]
        [--npx N --npz K] --steps S [--device cuda|cpu]

Both presets are Held-Suarez c48-L72, dt 600 s, n_split 6, hord_tm 6, the
configuration of the repository's headline benchmark (bench.py).
`held_suarez_c48_l72_fused` is the one bench.py runs on its accelerator:
the fused substep (pallas_dycore=True; CUDA kernels dsw_csw1, dsw_csw2,
dsw_transport, dsw_wind and dsw_tracer_acc).  `held_suarez_c48_l72` runs
the eager PyTorch substep instead.  CUDA is required unless `--device cpu`
is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from geosongpu_tpu.core.config import DycoreConfig

PRESETS = {
    "held_suarez_c48_l72": DycoreConfig(npx=48, npz=72, dt=600.0, n_split=6,
                                        hord_tm=6, pallas_dycore=False),
    "held_suarez_c48_l72_fused": DycoreConfig(npx=48, npz=72, dt=600.0,
                                              n_split=6, hord_tm=6,
                                              pallas_dycore=True),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="geosongpu-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run the Held-Suarez model")
    run.add_argument("--preset", default="held_suarez_c48_l72",
                     choices=sorted(PRESETS))
    run.add_argument("--npx", type=int, default=None)
    run.add_argument("--npz", type=int, default=None)
    run.add_argument("--steps", type=int, default=8)
    run.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch

    from .models.held_suarez import build_model

    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("CUDA is not available; pass --device cpu to run on the CPU")
    cfg = PRESETS[args.preset]
    if args.npx is not None:
        cfg = dataclasses.replace(cfg, npx=args.npx)
    if args.npz is not None:
        cfg = dataclasses.replace(cfg, npz=args.npz)
    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    model = build_model(cfg, device)
    state = model.init(perturb=1e-3)
    t0 = time.perf_counter()
    state = model.step(state)   # warm-up: kernel build, allocator
    sync()
    print(f"first step: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    state = model.run(state, args.steps)
    sync()
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"c{cfg.npx}-L{cfg.npz} on {where}: {args.steps} steps in "
          f"{dt:.3f} s ({dt / args.steps * 1e3:.2f} ms/step); "
          f"ps range {float(state.ps.min()):.0f}..{float(state.ps.max()):.0f}"
          f" Pa; max|u| {float(state.u.abs().max()):.2f} m/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The resolution ladder of the port: Held-Suarez c48-L72 and c192-L72
through the fused kernels, gridpoints/s on one card (the counterpart of
scripts/bench_ladder.py, which shells out to the JAX package's bench.py).

    python -m geosongpu_tpu_torch.scripts.bench_ladder [--rungs 48,192]
        [--npz 72] [--steps 20] [--device cuda|cpu]
        [--out .ci_workspace/bench_ladder.json]

Each rung builds its preset's model in this process
(`held_suarez_c48_l72_fused` up to npx 96, `held_suarez_c192_l72_fused`
above: the blend damping form and n_split 8, with which c192 stays
finite), takes 3 warm-up steps from
init(perturb=1e-3), then times `--steps` steps with the device
synchronised before and after.  A rung whose state is not finite after
the timed steps is an error entry with no speed: the reference ladder has
no such check, and its c192 rung at n_split 6 was once timed on NaN.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from . import card_line, device_of

WARMUP = 3


def preset_for(npx: int) -> str:
    return ("held_suarez_c48_l72_fused" if npx <= 96
            else "held_suarez_c192_l72_fused")


def non_finite(state) -> list:
    """The state's fields that hold a non-finite value."""
    return [f.name for f in dataclasses.fields(state)
            if not bool(getattr(state, f.name).isfinite().all())]


def run_rung(npx: int, npz: int, steps: int, device, start=None) -> dict:
    """One rung: `start` (default the model's init(perturb=1e-3)), 3
    warm-up steps, `steps` timed steps."""
    from ..cli import PRESETS, build_model_for
    from ..device import synchronize

    name = preset_for(npx)
    cfg = dataclasses.replace(PRESETS[name], npx=npx, npz=npz)
    model = build_model_for(name)(cfg, device)
    state = model.init(perturb=1e-3) if start is None else start
    state = model.run(state, WARMUP)
    synchronize(device)
    t0 = time.perf_counter()
    state = model.run(state, steps)
    synchronize(device)
    secs = (time.perf_counter() - t0) / steps
    entry = {"config": f"c{npx}-L{npz}", "preset": name,
             "n_split": cfg.n_split, "steps": steps,
             "card": card_line(device)}
    bad = non_finite(state)
    if bad:
        entry.update(finite=False, error=f"non-finite {', '.join(bad)} after "
                     f"{WARMUP} + {steps} steps")
        return entry
    entry.update(finite=True, ms_per_step=1e3 * secs,
                 gridpoints_per_s=6 * npx * npx * npz / secs)
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_ladder")
    ap.add_argument("--rungs", default="48,192")
    ap.add_argument("--npz", type=int, default=72)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(".ci_workspace",
                                                  "bench_ladder.json"))
    args = ap.parse_args(argv)
    device = device_of(args.device)
    entries = [run_rung(int(r), args.npz, args.steps, device)
               for r in args.rungs.split(",")]
    artifact = {"device": str(device), "card": card_line(device),
                "path": "fused CUDA kernels (pallas_dycore=True)",
                "entries": entries}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact, indent=1))
    return 0 if all(e["finite"] for e in entries) else 1


if __name__ == "__main__":
    sys.exit(main())

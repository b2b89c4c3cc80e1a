"""Per-phase timing of a Held-Suarez preset's step on one device (the
counterpart of scripts/phase_profile.py).

    python -m geosongpu_tpu_torch.scripts.phase_profile
        [--preset held_suarez_c48_l72_fused] [--npx N] [--npz K]
        [--device cuda|cpu]

Prints one JSON dict of phase -> ms per step: the full step and the
leaves of benchmark/phases.measure_phases (the phase tree of the CI's
Benchmark records) on the preset's model from init(perturb=1e-3), with
`_config`, `_device` and `_card` beside them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from . import card_line, device_of, hs_presets


def profile(preset: str, npx=None, npz=None, device="cuda",
            inner: int = 30) -> dict:
    """The phase dict of `preset` (npx, npz: its size, default the
    preset's); inner: calls a block of each leaf's chained timing."""
    from ..benchmark.phases import measure_phases
    from ..cli import PRESETS, build_model_for

    device = device_of(str(device))
    cfg = PRESETS[preset]
    cfg = dataclasses.replace(cfg, npx=npx or cfg.npx, npz=npz or cfg.npz)
    model = build_model_for(preset)(cfg, device)
    tree = measure_phases(model, model.init(perturb=1e-3), inner=inner)
    d = tree.to_dict()
    return {"full_step": d["full_step_ms"], **d["phases_ms"],
            "_config": f"{preset} c{cfg.npx}-L{cfg.npz} n_split "
                       f"{cfg.n_split}",
            "_device": str(device), "_card": card_line(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="phase_profile")
    ap.add_argument("--preset", default="held_suarez_c48_l72_fused",
                    choices=hs_presets())
    ap.add_argument("--npx", type=int, default=None)
    ap.add_argument("--npz", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.preset, args.npx, args.npz, args.device),
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

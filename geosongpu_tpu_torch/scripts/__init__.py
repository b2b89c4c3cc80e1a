"""The tool scripts of the port (the counterparts of the repository's
scripts/ for the JAX package), run as `python -m
geosongpu_tpu_torch.scripts.<name>`: bench_ladder, phase_profile, roofline
and hs_climatology.  Each runs on the card unless given `--device cpu`,
and raises where there is no card."""
from __future__ import annotations

import subprocess

import torch


def device_of(name: str) -> torch.device:
    """The torch device `name` ("cuda" or "cpu"); "cuda" raises where
    there is no card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    return device


def hs_presets() -> list:
    """The Held-Suarez presets of cli.PRESETS (those not in cli.MODELS)."""
    from ..cli import MODELS, PRESETS

    return sorted(p for p in PRESETS if p not in MODELS)


def card_line(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]

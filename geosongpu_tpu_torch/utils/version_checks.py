"""Component-version drift checks (the port's form of
geosongpu_tpu/utils/version_checks.py): the runtime stack's fingerprint
(torch and its CUDA, NVML's software version, Python, numpy, the devices)
against a recorded manifest, so that a change of the stack under the CI
shows.
"""
from __future__ import annotations

import importlib.metadata as md
import json
import sys
from typing import Dict, List, Tuple


def stack_fingerprint() -> Dict[str, str]:
    """Where torch sees a card, `driver` is NVML's software version (an
    NVML that cannot be read raises) and `devices` names the cards."""
    import numpy
    import torch

    out = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "numpy": numpy.__version__,
        "python": sys.version.split()[0],
    }
    try:
        out["triton"] = md.version("triton")
    except md.PackageNotFoundError:
        pass
    if torch.cuda.is_available():
        from ..hws.nvml import NVML

        with NVML() as nvml:
            out["driver"] = nvml.driver_version()
        out["devices"] = ",".join(sorted({
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())}))
    else:
        out["devices"] = "cpu"
    return out


def save_manifest(path: str) -> Dict[str, str]:
    fp = stack_fingerprint()
    with open(path, "w") as f:
        json.dump(fp, f, indent=2, sort_keys=True)
    return fp


def compare_with_manifest(path: str) -> Tuple[bool, List[str]]:
    with open(path) as f:
        recorded = json.load(f)
    current = stack_fingerprint()
    diffs = []
    for k in sorted(set(recorded) | set(current)):
        a, b = recorded.get(k), current.get(k)
        if a != b:
            diffs.append(f"{k}: recorded={a} current={b}")
    return (not diffs, diffs)

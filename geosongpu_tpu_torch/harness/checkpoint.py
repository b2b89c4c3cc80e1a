"""Model state checkpoint and resume (the port's counterpart of
geosongpu_tpu/harness/checkpoint.py).

The reference's portable form only: every DycoreState field in one
`ckpt_{step:08d}/state.npz` (np.savez_compressed, the reference's fallback
when orbax is absent) and `meta_{step:08d}.json` with the step and the
config, under the reference's keys.  There is no compilation cache to warm:
the kernel library is built once per source hash and kept
(ops/kernels/build.py).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from ..core.config import DycoreConfig
from ..core.state import DycoreState, state_from_numpy, state_to_numpy


def save(directory: str, state: DycoreState, config: DycoreConfig,
         step: int = 0) -> str:
    """Save a checkpoint; returns the checkpoint path."""
    path = os.path.join(directory, f"ckpt_{step:08d}")
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "state.npz"),
                        **state_to_numpy(state))
    with open(os.path.join(directory, f"meta_{step:08d}.json"), "w") as f:
        json.dump({"step": step, "config": dataclasses.asdict(config)}, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1].split(".")[0])
             for name in os.listdir(directory) if name.startswith("meta_")]
    return max(steps) if steps else None


def restore(directory: str, device, step: Optional[int] = None
            ) -> Tuple[DycoreState, int]:
    """The checkpoint at `step` (default: the latest) as a state on
    `device`, and its step.  Raises if a field is not float32."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    npz = os.path.join(directory, f"ckpt_{step:08d}", "state.npz")
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    for name, a in arrays.items():
        if a.dtype != np.float32:
            raise TypeError(f"checkpoint field {name} is {a.dtype}, "
                            "expected float32")
    state = state_from_numpy(arrays, device)
    state.check_f32()
    return state, step

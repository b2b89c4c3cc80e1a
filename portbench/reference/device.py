"""Frozen copy of geosongpu_tpu_torch/device.py at commit f902e7ad95fb,
unchanged but for this note.

The f32 policy and numpy <-> torch conversion.

The dynamical core runs in float32 everywhere (DycoreConfig.dtype), as the
reference does.  TF32 is switched off for matmuls and convolutions: the
chart-corner einsums and every pressure integral need full f32 mantissas.
There is no implicit device: every build_* function takes an explicit one.
"""
from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def to_torch(a, device) -> torch.Tensor:
    """numpy (or array-like) -> a new tensor on `device`.  Floating arrays
    become float32 BEFORE they reach torch: `torch.as_tensor` keeps
    float64, and a single f64 metric would silently promote the whole
    step.  The data is copied, so read-only sources are safe."""
    arr = np.asarray(a)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    elif arr.dtype.kind in "iu":
        arr = arr.astype(np.int64)
    else:
        arr = np.array(arr)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def synchronize(device) -> None:
    """Wait for the work queued on `device` (a card); nothing on the CPU,
    whose work is done when the call returns."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

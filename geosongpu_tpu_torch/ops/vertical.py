"""Vertical-column primitives (counterpart of geosongpu_tpu/ops/vertical.py).

The reference writes its K-cumsums as triangular matmuls because the TPU
lowers a lane cumsum to an O(K^2) reduce-window; on the GPU a scan along
the contiguous minor axis is the natural form, so these are torch.cumsum.
"""
from __future__ import annotations

import torch


def cumsum_k(x: torch.Tensor) -> torch.Tensor:
    """Inclusive forward cumsum along the last axis."""
    return torch.cumsum(x, dim=-1)


def rcumsum_k(x: torch.Tensor) -> torch.Tensor:
    """Inclusive reverse cumsum (suffix sum) along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), dim=-1), (-1,))


def interfaces_from_delp(delp: torch.Tensor, ptop: float) -> torch.Tensor:
    """Interface pressures pe [..., K+1] from layer thickness [..., K]."""
    return ptop + torch.cat([torch.zeros_like(delp[..., :1]), cumsum_k(delp)],
                            dim=-1)

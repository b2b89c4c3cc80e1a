"""Vertical-column primitives (counterpart of geosongpu_tpu/ops/vertical.py).

The reference writes its K-cumsums as triangular matmuls because the TPU
lowers a lane cumsum to an O(K^2) reduce-window; on the GPU a scan along
the contiguous minor axis is the natural form, so these are torch.cumsum.
The sums accumulate in float64 and round once to float32, as torch.cumsum
of a float32 tensor already does on the CPU; the card's float32 scan
otherwise moves pkz through the ill-conditioned dpk of thin layers and the
c48-L72 substep winds by up to 7e-2 m/s against the CPU (measured on an
H100).  The column kernels (csrc/dsw_common.cuh) sum in double too.
"""
from __future__ import annotations

import torch


def cumsum_k(x: torch.Tensor) -> torch.Tensor:
    """Inclusive forward cumsum along the last axis."""
    return torch.cumsum(x, dim=-1, dtype=torch.float64).to(x.dtype)


def rcumsum_k(x: torch.Tensor) -> torch.Tensor:
    """Inclusive reverse cumsum (suffix sum) along the last axis."""
    return torch.flip(cumsum_k(torch.flip(x, (-1,))), (-1,))


def interfaces_from_delp(delp: torch.Tensor, ptop: float) -> torch.Tensor:
    """Interface pressures pe [..., K+1] from layer thickness [..., K]."""
    return ptop + torch.cat([torch.zeros_like(delp[..., :1]), cumsum_k(delp)],
                            dim=-1)

"""Column-stencil idioms in plain PyTorch (the port's counterpart of
geosongpu_tpu/ops/column_patterns.py): a data-dependent iteration per
column, the column top or bottom broadcast to every level, the value at a
level that varies per column, and the first level above a threshold.
Arrays are [..., K], top -> surface."""
from __future__ import annotations

import torch


def while_in_column(q: torch.Tensor, threshold: float,
                    max_iter: int = 50) -> torch.Tensor:
    """Repeatedly diffuse each column (1-2-1 weights, edge values
    repeated) until its max-min spread falls below `threshold`, at most
    `max_iter` times; a converged column is frozen while the others go
    on."""

    def spread(x):
        return (torch.amax(x, dim=-1, keepdim=True)
                - torch.amin(x, dim=-1, keepdim=True))

    x = q
    for _ in range(max_iter):
        active = spread(x) > threshold
        if not bool(active.any()):
            break
        xp = torch.cat([x[..., :1], x, x[..., -1:]], dim=-1)
        sm = 0.25 * xp[..., :-2] + 0.5 * xp[..., 1:-1] + 0.25 * xp[..., 2:]
        x = torch.where(active, sm, x)
    return x


def broadcast_top(q: torch.Tensor) -> torch.Tensor:
    """The column-top value at every level."""
    return q[..., :1].expand(q.shape)


def broadcast_bottom(q: torch.Tensor) -> torch.Tensor:
    return q[..., -1:].expand(q.shape)


def value_at_k(q: torch.Tensor, k_index: torch.Tensor) -> torch.Tensor:
    """Per-column value at level k_index ([...] one level per column, or
    [..., K]-broadcastable): a mask and a sum over K, as the reference
    forms it."""
    ks = torch.arange(q.shape[-1], device=q.device)
    mask = (ks == k_index[..., None]) if k_index.dim() == q.dim() - 1 \
        else (ks == k_index)
    return torch.where(mask, q, torch.zeros((), dtype=q.dtype,
                                             device=q.device)).sum(dim=-1)


def first_k_above(q: torch.Tensor, threshold: float) -> torch.Tensor:
    """Lowest k (top -> surface order) where q exceeds threshold; K if
    none."""
    K = q.shape[-1]
    hit = q > threshold
    idx = torch.argmax(hit.to(torch.int32), dim=-1)
    return torch.where(hit.any(dim=-1), idx, torch.full_like(idx, K))

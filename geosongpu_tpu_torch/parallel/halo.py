"""Single-device halo fills as index gathers (geosongpu_tpu/parallel/halo.py).

The numpy gather tables of `core.topology.halo_spec` are applied with
`index_select` on a flat view of the face-stacked field.  That is the
table form the reference's concat recipes were fitted to and verified
against, so the padded arrays are bit-identical to the reference's.

Not here: `fill_vector` and `fill_cgrid`, which no path of the port's
models calls (ROADMAP queue A item 13, with the cross-device fills).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..core.topology import NFACES, edge_twins, halo_spec
from ..device import to_torch


@dataclass(frozen=True)
class HaloOps:
    """Gather tables + fill ops for one (n, h) on one device."""

    n: int
    h: int
    gidx_x: torch.Tensor   # [6*N*N] flat cell index, x-order corners
    gidx_y: torch.Tensor
    u_idx: torch.Tensor    # [6*(N+1)*N] index into concat(u.flat, v.flat)
    u_sgn: torch.Tensor    # [6*(N+1)*N] float +-1 (tangential sign)
    v_idx: torch.Tensor
    v_sgn: torch.Tensor

    @property
    def ny(self) -> int:
        return self.n

    @property
    def nx(self) -> int:
        return self.n

    @property
    def device(self) -> torch.device:
        return self.gidx_x.device

    def fill(self, field: torch.Tensor, direction: str = "x") -> torch.Tensor:
        """[6, n, n, ...] -> padded [6, N, N, ...].  direction picks the
        corner-block table: 'x' for x-direction stencils, 'y' for y."""
        if direction not in ("x", "y"):
            raise ValueError(f"direction must be 'x' or 'y', got {direction!r}")
        n, N = self.n, self.n + 2 * self.h
        trail = field.shape[3:]
        gidx = self.gidx_x if direction == "x" else self.gidx_y
        flat = field.reshape((NFACES * n * n,) + trail)
        return flat.index_select(0, gidx).reshape((NFACES, N, N) + trail)

    def fill_dgrid(self, u: torch.Tensor, v: torch.Tensor):
        """u [6, n+1, n, ...], v [6, n, n+1, ...] -> padded
        u [6, N+1, N, ...], v [6, N, N+1, ...] with the u<->v swap and sign
        changes across rotated face edges."""
        n, N = self.n, self.n + 2 * self.h
        trail = u.shape[3:]
        flat = torch.cat([u.reshape((-1,) + trail), v.reshape((-1,) + trail)])
        extra = (1,) * len(trail)
        pu = flat.index_select(0, self.u_idx) * self.u_sgn.view((-1,) + extra)
        pv = flat.index_select(0, self.v_idx) * self.v_sgn.view((-1,) + extra)
        return (pu.reshape((NFACES, N + 1, N) + trail),
                pv.reshape((NFACES, N, N + 1) + trail))

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)


def build_halo_ops(n: int, h: int, device) -> HaloOps:
    spec = halo_spec(n, h)
    flat = lambda a: to_torch(a.reshape(-1), device)
    return HaloOps(
        n=n, h=h,
        gidx_x=flat(spec.gidx_x), gidx_y=flat(spec.gidx_y),
        u_idx=flat(spec.u_idx), u_sgn=flat(spec.u_sgn.astype("float32")),
        v_idx=flat(spec.v_idx), v_sgn=flat(spec.v_sgn.astype("float32")),
    )


@functools.lru_cache(maxsize=8)
def _twin_tables(n: int, device: torch.device):
    idx_a, idx_b, sgn = edge_twins(n)
    return (to_torch(idx_a, device), to_torch(idx_b, device),
            to_torch(sgn.astype("float32"), device))


def symmetrize_shared_edges(u: torch.Tensor, v: torch.Tensor):
    """Average the two independently prognosed copies of every shared
    face-boundary staggered wind entry.  u [6, n+1, n, ...], v [6, n, n+1,
    ...].  Writes the a-copies first and then the b-copies, as the
    reference does (the index sets are disjoint, so the order only matters
    for bit-for-bit agreement)."""
    idx_a, idx_b, sgn = _twin_tables(u.shape[2], u.device)
    trail = u.shape[3:]
    uf = u.reshape((-1,) + trail)
    vf = v.reshape((-1,) + trail)
    flat = torch.cat([uf, vf])
    s = sgn.view((-1,) + (1,) * len(trail))
    mean = 0.5 * (flat.index_select(0, idx_a) + s * flat.index_select(0, idx_b))
    flat = flat.index_copy(0, idx_a, mean).index_copy(0, idx_b, s * mean)
    nu = uf.shape[0]
    return flat[:nu].reshape(u.shape), flat[nu:].reshape(v.shape)

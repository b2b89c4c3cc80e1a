"""Frozen copy of geosongpu_tpu_torch/parallel/halo.py at commit f902e7ad95fb,
unchanged but for this note.

Single-device halo fills as index gathers (geosongpu_tpu/parallel/halo.py).

The numpy gather tables of `core.topology.halo_spec` are applied with
`index_select` on a flat view of the face-stacked field.  That is the
table form the reference's concat recipes were fitted to and verified
against, so the padded arrays are bit-identical to the reference's.

`fill_vector` and `fill_cgrid` are the single-device references of the
sharded fills (parallel/subtile.py).
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
    u_sgn_n: torch.Tensor  # normal-component signs (C-grid fills)
    v_sgn_n: torch.Tensor
    # cell-centred vectors, per corner order: swap flag and the two signs
    vswap_x: torch.Tensor  # [6*N*N] bool
    vsy_x: torch.Tensor
    vsx_x: torch.Tensor
    vswap_y: torch.Tensor
    vsy_y: torch.Tensor
    vsx_y: torch.Tensor

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

    def fill_vector(self, vy: torch.Tensor, vx: torch.Tensor,
                    direction: str = "x"):
        """Pad a cell-centred vector (y-component, x-component), with the
        signed-permutation frame change in the halo."""
        if direction == "x":
            sw, sy, sx = self.vswap_x, self.vsy_x, self.vsx_x
        else:
            sw, sy, sx = self.vswap_y, self.vsy_y, self.vsx_y
        py = self.fill(vy, direction)
        px = self.fill(vx, direction)
        shape = py.shape[:3] + (1,) * (py.ndim - 3)
        sw, sy, sx = sw.view(shape), sy.view(shape), sx.view(shape)
        return sy * torch.where(sw, px, py), sx * torch.where(sw, py, px)

    def _stag_fill(self, a, b, sgn_u, sgn_v):
        """Gather a u-staggered and a v-staggered field through the u and v
        tables, with the given signs."""
        n, N = self.n, self.n + 2 * self.h
        trail = a.shape[3:]
        flat = torch.cat([a.reshape((-1,) + trail), b.reshape((-1,) + trail)])
        extra = (1,) * len(trail)
        pa = flat.index_select(0, self.u_idx) * sgn_u.view((-1,) + extra)
        pb = flat.index_select(0, self.v_idx) * sgn_v.view((-1,) + extra)
        return (pa.reshape((NFACES, N + 1, N) + trail),
                pb.reshape((NFACES, N, N + 1) + trail))

    def fill_dgrid(self, u: torch.Tensor, v: torch.Tensor):
        """u [6, n+1, n, ...], v [6, n, n+1, ...] -> padded
        u [6, N+1, N, ...], v [6, N, N+1, ...] with the u<->v swap and sign
        changes across rotated face edges."""
        return self._stag_fill(u, v, self.u_sgn, self.v_sgn)

    def fill_cgrid(self, uc: torch.Tensor, vc: torch.Tensor):
        """uc [6, n, n+1, ...]: x-normal wind on W/E interfaces (v-points);
        vc [6, n+1, n, ...]: y-normal wind on S/N interfaces (u-points) ->
        padded (puc, pvc).  The D-grid tables with the normal-component
        signs."""
        pvc, puc = self._stag_fill(vc, uc, self.u_sgn_n, self.v_sgn_n)
        return puc, pvc

    def interior(self, padded: torch.Tensor) -> torch.Tensor:
        """Strip the halo of a padded cell-centred array."""
        h = self.h
        return padded[:, h:h + self.ny, h:h + self.nx]

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)


def build_halo_ops(n: int, h: int, device) -> HaloOps:
    spec = halo_spec(n, h)
    flat = lambda a: to_torch(a.reshape(-1), device)
    sign = lambda a: flat(a.astype("float32"))
    flag = lambda a: torch.as_tensor(a.reshape(-1).astype(bool), device=device)
    return HaloOps(
        n=n, h=h,
        gidx_x=flat(spec.gidx_x), gidx_y=flat(spec.gidx_y),
        u_idx=flat(spec.u_idx), u_sgn=sign(spec.u_sgn),
        v_idx=flat(spec.v_idx), v_sgn=sign(spec.v_sgn),
        u_sgn_n=sign(spec.u_sgn_n), v_sgn_n=sign(spec.v_sgn_n),
        vswap_x=flag(spec.vswap_x), vsy_x=sign(spec.vsy_x),
        vsx_x=sign(spec.vsx_x), vswap_y=flag(spec.vswap_y),
        vsy_y=sign(spec.vsy_y), vsx_y=sign(spec.vsx_y),
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

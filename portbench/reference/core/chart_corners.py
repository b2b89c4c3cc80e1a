"""Frozen copy of geosongpu_tpu_torch/core/chart_corners.py at commit
f902e7ad95fb, unchanged but for this note.

Cube-corner chart corrections (geosongpu_tpu/core/chart_corners.py).

Inside the 8 h x h cube-corner halo blocks the x-order scalar fill, the
y-order fill and the two staggered-wind fills each draw from a different
owner face.  This module makes every padded value and every metric in a
corner block a sample of one smooth object, the face's analytically
extended equiangular chart:

* scalars are resampled onto the chart cell-centre gridpoints from the
  surrounding filled samples with quadratic-exact min-norm weights, in
  deviation form so uniform fields stay bit-exact; afterwards the x- and
  y-order fills agree everywhere;
* staggered / A-grid winds are reconstructed by a least-squares quadratic
  vector fit of all pu/pv samples near a corner;
* the basis-angle metrics and the corner interpolation weights are
  re-evaluated from chart geometry inside the corner regions.

The table side (`ChartCornerTables`, `build_chart_tables`,
`chart_cosa_overrides`, `chart_corner_dw`) is numpy, the port's own copy
of the reference's table functions, held to them bit for bit by
tests/test_torch_core.py.  The apply side (`ChartCorners`) moves the
weights to the device once and applies them with torch, in the
reference's order: each corner's patch is read from the INPUT array and
its base from the running output, one static-slice block update per
corner.  The weights are per slot of the leading axis: the six faces on
one device, or, for the blocks of a sharded step, each block's face with
the corners its block does not own gated off (`sharded_chart_for_subtile`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import to_torch
from .topology import FACE_FRAMES, NFACES, face_point, halo_spec

# --------------------------------------------------------------------------
# tables (numpy)
# --------------------------------------------------------------------------

# patch width (cells) read by every corner operator; covers the h-deep
# corner block plus enough valid neighbors for a well-poised quadratic
_PW_EXTRA = 4


def _patch_width(h: int) -> int:
    return h + _PW_EXTRA


def _basis_at(f: int, q: np.ndarray):
    """Unit tangent vectors (e1, e2) of face f's chart at unit points q."""
    _, a_, b_ = FACE_FRAMES[f]
    e1 = a_ - np.sum(a_ * q, -1, keepdims=True) * q
    e2 = b_ - np.sum(b_ * q, -1, keepdims=True) * q
    e1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = e2 / np.linalg.norm(e2, axis=-1, keepdims=True)
    return e1, e2


def _tangent_frame(p: np.ndarray):
    """Orthonormal tangent basis (t1, t2) at unit point p."""
    helper = np.where(np.abs(p[..., :1]) < 0.9,
                      np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]))
    t1 = np.cross(p, helper)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(p, t1)
    return t1, t2


# corner id -> (is_north, is_east); patch slices derive from these
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))   # SW, SE, NW, NE


def _corner_patch_slices(size_y: int, size_x: int, P_y: int, P_x: int,
                         cid: int) -> Tuple[slice, slice]:
    isn, ise = _CORNERS[cid]
    ys = slice(size_y - P_y, size_y) if isn else slice(0, P_y)
    xs = slice(size_x - P_x, size_x) if ise else slice(0, P_x)
    return ys, xs


def _block_slices(size_y: int, size_x: int, h: int, cid: int,
                  ry: int = 0, rx: int = 0) -> Tuple[slice, slice]:
    """The h x h(+stagger) corner-block target slots within the array."""
    isn, ise = _CORNERS[cid]
    ys = slice(size_y - h, size_y) if isn else slice(0, h)
    xs = slice(size_x - h, size_x) if ise else slice(0, h)
    return ys, xs


def _minnorm_quadratic(pts_xy: np.ndarray, tgt_xy: np.ndarray,
                       ridge: float = 1e-10) -> np.ndarray:
    """Min-norm quadratic-exact interpolation weights.

    pts_xy [S, 2]: sample coords, tgt_xy [T, 2]: target coords (same
    scaled tangent frame).  Returns W [T, S] with  W @ phi(pts) =
    phi(tgt)  for phi = (1, x, y, x^2, xy, y^2), minimizing ||W||."""
    def phi(xy):
        x, y = xy[..., 0], xy[..., 1]
        return np.stack([np.ones_like(x), x, y, x * x, x * y, y * y],
                        axis=-1)
    A = phi(pts_xy)                      # [S, 6]
    B = phi(tgt_xy)                      # [T, 6]
    G = A.T @ A + ridge * np.eye(6)
    lam = np.linalg.solve(G, B.T)        # [6, T]
    return (A @ lam).T                   # [T, S]


def _target_region(N: int, h: int, cid: int):
    """Halo slots near a cube corner that need chart reconstruction.

    The corner contaminates not just the h x h corner block but the
    adjacent strip slots whose resample stencils reached into it
    (measured: up to 130 m/s at the strip slot diagonally next to the
    block).  Region = the W x W corner square (W = h + 2) minus its
    interior-only part; returns (J_idx, I_idx) int arrays."""
    W = h + 2
    isn, ise = _CORNERS[cid]
    rows = np.arange(N - W, N) if isn else np.arange(W)
    cols = np.arange(N - W, N) if ise else np.arange(W)
    J, I = np.meshgrid(rows, cols, indexing="ij")
    in_halo_j = (J >= N - h) if isn else (J < h)
    in_halo_i = (I >= N - h) if ise else (I < h)
    sel = in_halo_j | in_halo_i
    return J[sel].astype(np.int32), I[sel].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ChartCornerTables:
    """Static corner-correction weights (numpy; converted lazily)."""

    n: int
    h: int
    # scalar resample: [6, 4, W*W, P*P] weights over the P x P padded
    # patch, DENSE over the W x W corner square (zero rows = passthrough
    # in deviation form); applied as one static-slice block update per
    # corner, preserving uniform fields bit-exactly
    sc_dw_x: np.ndarray
    sc_dw_y: np.ndarray
    sc_jidx: np.ndarray       # [4, T_sc] absolute target slots (probes)
    sc_iidx: np.ndarray
    # one-sided scalar resample for DERIVED fields (e.g. the center
    # vorticity) whose corner L-region values are invalid: weights draw
    # ONLY from the valid patch slots (strips + interior), zeros on the
    # L-region columns
    sc_ex: np.ndarray         # [6, 4, T_sc, P*P]
    # A-grid wind reconstruction: samples = pu patch then pv patch flat;
    # rows = ua square then va square (dense over W x W; st_mask marks
    # the true target slots - the rest keep their current values)
    st_w: np.ndarray          # [6, 4, 2*W*W, S]
    st_mask: np.ndarray       # [4, W*W] bool
    st_jidx: np.ndarray       # [4, T_sc]
    st_iidx: np.ndarray


def _chart_coords(n: int, h: int):
    dxi = (np.pi / 2) / n
    cen = (np.arange(-h, n + h) + 0.5) * dxi - np.pi / 4     # length N
    ifc = np.arange(-h, n + h + 1) * dxi - np.pi / 4         # length N+1
    return cen, ifc


def build_chart_tables(n: int, h: int) -> ChartCornerTables:
    spec = halo_spec(n, h)
    N = n + 2 * h
    P = _patch_width(h)
    cen, ifc = _chart_coords(n, h)

    # ---- true positions of filled samples -------------------------------
    c0, _ = _chart_coords(n, 0)
    centers = np.zeros((NFACES, n, n, 3))
    corners = np.zeros((NFACES, n + 1, n + 1, 3))
    for f in range(NFACES):
        CJ, CI = np.meshgrid(c0, c0, indexing="ij")
        centers[f] = face_point(f, CI, CJ)
        s0 = np.arange(n + 1) * (np.pi / 2) / n - np.pi / 4
        SJ, SI = np.meshgrid(s0, s0, indexing="ij")
        corners[f] = face_point(f, SI, SJ)
    flatc = centers.reshape(-1, 3)
    pos_x = flatc[spec.gidx_x]            # [6, N, N, 3]
    pos_y = flatc[spec.gidx_y]

    # staggered sample positions + directions (owner basis x fill sign)
    ymid = corners[:, :, :-1] + corners[:, :, 1:]
    ymid /= np.linalg.norm(ymid, axis=-1, keepdims=True)  # u-points
    xmid = corners[:, :-1, :] + corners[:, 1:, :]
    xmid /= np.linalg.norm(xmid, axis=-1, keepdims=True)  # v-points
    u_count = NFACES * (n + 1) * n

    def stag_pos_dir(idx, sgn):
        """True position and sampling direction of every staggered slot."""
        is_v = idx >= u_count
        g = np.where(is_v, (idx - u_count) // (n * (n + 1)),
                     idx // ((n + 1) * n))
        rem_u = idx % ((n + 1) * n)
        rem_v = (idx - u_count) % (n * (n + 1))
        j = np.where(is_v, rem_v // (n + 1), rem_u // n)
        i = np.where(is_v, rem_v % (n + 1), rem_u % n)
        # clip per branch: u entries index ymid [n+1, n], v entries
        # xmid [n, n+1] (np.where evaluates both)
        pos = np.where(is_v[..., None],
                       xmid[g, np.minimum(j, n - 1), i],
                       ymid[g, j, np.minimum(i, n - 1)])
        d = np.zeros(pos.shape)
        for f in range(NFACES):
            m_u = (~is_v) & (g == f)
            m_v = is_v & (g == f)
            if m_u.any():
                d[m_u] = _basis_at(f, pos[m_u])[0]   # u stores e1 . V
            if m_v.any():
                d[m_v] = _basis_at(f, pos[m_v])[1]   # v stores e2 . V
        return pos, d * sgn[..., None]

    upos, udir = stag_pos_dir(np.asarray(spec.u_idx),
                              np.asarray(spec.u_sgn, np.float64))
    vpos, vdir = stag_pos_dir(np.asarray(spec.v_idx),
                              np.asarray(spec.v_sgn, np.float64))

    # ---- chart target positions ----------------------------------------
    chart_c = np.zeros((NFACES, N, N, 3))
    for f in range(NFACES):
        CJ, CI = np.meshgrid(cen, cen, indexing="ij")
        chart_c[f] = face_point(f, CI, CJ)

    PP = P * P
    scale = (np.pi / 2) / n

    sc_jidx, sc_iidx = [], []
    for cid in range(4):
        J, I = _target_region(N, h, cid)
        sc_jidx.append(J)
        sc_iidx.append(I)
    T_sc = len(sc_jidx[0])
    sc_dw_x = np.zeros((NFACES, 4, T_sc, PP))
    sc_dw_y = np.zeros((NFACES, 4, T_sc, PP))
    sc_ex = np.zeros((NFACES, 4, T_sc, PP))
    st_w = np.zeros((NFACES, 4, 2 * T_sc, (P + 1) * P + P * (P + 1)))

    for f in range(NFACES):
        for cid in range(4):
            ys, xs = _corner_patch_slices(N, N, P, P, cid)
            Jt, It = sc_jidx[cid], sc_iidx[cid]
            # tangent frame at the cube corner
            isn, ise = _CORNERS[cid]
            pc = face_point(f, np.pi / 4 * (1 if ise else -1),
                            np.pi / 4 * (1 if isn else -1))
            pc = pc / np.linalg.norm(pc)
            t1, t2 = _tangent_frame(pc)

            def xy(pos):
                d = pos - pc
                return np.stack([d @ t1, d @ t2], axis=-1) / scale

            tgt = xy(chart_c[f][Jt, It])                   # [T_sc, 2]
            for pos, out in ((pos_x, sc_dw_x), (pos_y, sc_dw_y)):
                pts = xy(pos[f][ys, xs].reshape(-1, 3))    # [PP, 2]
                out[f, cid] = _minnorm_quadratic(pts, tgt)
            # exclude-L weights: valid samples only.  Positions: after the
            # include-L correction the L slots hold chart values, but for
            # DERIVED fields (computed per-substep from padded data) the L
            # values are invalid; resample from the valid slots' CHART
            # positions (strips are chart samples after the per-cell
            # machinery; interior is trivially chart)
            pj, pi = np.meshgrid(np.arange(ys.start, ys.stop),
                                 np.arange(xs.start, xs.stop),
                                 indexing="ij")
            in_L = np.zeros((N, N), bool)
            in_L[Jt, It] = True
            valid = ~in_L[pj, pi].ravel()
            pts_c = xy(chart_c[f][ys, xs].reshape(-1, 3))
            Wv = _minnorm_quadratic(pts_c[valid], tgt)
            Wfull = np.zeros((T_sc, PP))
            Wfull[:, valid] = Wv
            sc_ex[f, cid] = Wfull

            # ---- A-grid reconstruction ------------------------------
            uys, uxs = _corner_patch_slices(N + 1, N, P + 1, P, cid)
            vys, vxs = _corner_patch_slices(N, N + 1, P, P + 1, cid)
            spu = upos[f][uys, uxs].reshape(-1, 3)
            dpu = udir[f][uys, uxs].reshape(-1, 3)
            spv = vpos[f][vys, vxs].reshape(-1, 3)
            dpv = vdir[f][vys, vxs].reshape(-1, 3)
            spos = np.concatenate([spu, spv])       # [S, 3]
            sdir = np.concatenate([dpu, dpv])
            sxy = xy(spos)
            dt1 = sdir @ t1
            dt2 = sdir @ t2

            def quad(xyv):
                x, y = xyv[..., 0], xyv[..., 1]
                return np.stack([np.ones_like(x), x, y, x * x, x * y,
                                 y * y], axis=-1)
            Phi = quad(sxy)                         # [S, 6]
            A = np.concatenate([Phi * dt1[:, None], Phi * dt2[:, None]],
                               axis=1)              # [S, 12]
            G = A.T @ A + 1e-9 * np.trace(A.T @ A) / 12 * np.eye(12)
            Ainv = np.linalg.solve(G, A.T)          # [12, S]

            tpos = chart_c[f][Jt, It]
            E1, E2 = _basis_at(f, tpos)
            txy = xy(tpos)
            Pt = quad(txy)

            def eval_rows(tdir):
                d1 = np.sum(tdir * t1, -1)
                d2 = np.sum(tdir * t2, -1)
                B = np.concatenate([Pt * d1[:, None], Pt * d2[:, None]],
                                   axis=1)
                return B @ Ainv
            st_w[f, cid] = np.concatenate(
                [eval_rows(E1), eval_rows(E2)], axis=0)

    # densify onto the W x W corner square (W = h + 2), target slots
    # addressed PATCH-RELATIVE so application generalizes to rectangular
    # local blocks; non-target rows are ZERO, which in deviation form is
    # an exact passthrough - the appliers then update each corner with a
    # single static-slice dynamic-update-slice (a gather/scatter with
    # advanced indices copies the whole padded array)
    W = h + 2
    WW = W * W
    T_sc = sc_dw_x.shape[2]
    S_st = st_w.shape[3]

    def _dense(tbl, ncomp=1):
        dense = np.zeros((NFACES, 4, ncomp * WW, tbl.shape[3] // 1
                          if False else tbl.shape[3]))
        for cid in range(4):
            ysq, xsq = _corner_patch_slices(N, N, W, W, cid)
            rows = ((sc_jidx[cid] - ysq.start) * W
                    + (sc_iidx[cid] - xsq.start))
            for c in range(ncomp):
                dense[:, cid, rows + c * WW] = \
                    tbl[:, cid, c * T_sc:(c + 1) * T_sc]
        return dense

    mask = np.zeros((4, WW), bool)
    for cid in range(4):
        ysq, xsq = _corner_patch_slices(N, N, W, W, cid)
        rows = ((sc_jidx[cid] - ysq.start) * W
                + (sc_iidx[cid] - xsq.start))
        mask[cid, rows] = True
    return ChartCornerTables(
        n=n, h=h,
        sc_dw_x=np.asarray(_dense(sc_dw_x), np.float32),
        sc_dw_y=np.asarray(_dense(sc_dw_y), np.float32),
        sc_jidx=np.asarray(sc_jidx), sc_iidx=np.asarray(sc_iidx),
        sc_ex=np.asarray(_dense(sc_ex), np.float32),
        st_w=np.asarray(_dense(st_w, ncomp=2), np.float32),
        st_mask=mask,
        st_jidx=np.asarray(sc_jidx), st_iidx=np.asarray(sc_iidx),
    )


def chart_cosa_overrides(n: int, h: int) -> dict:
    """Chart-evaluated basis-angle metrics blended into the corner
    regions (numpy [6, ...] arrays + boolean masks).

    With corner values resampled onto chart gridpoints, the metric must
    be evaluated at those SAME chart points - the gathered "true
    position" evaluation (exact for the raw fills) would mix positions.
    Returns {name: (values, mask)} for cosa_i/cosa_j/cosa_c/cosa_cn;
    consumers blend `np.where(mask, values, original)` and recompute the
    derived rsina/rsin2."""
    N = n + 2 * h
    cen, ifc = _chart_coords(n, h)

    def cos_grid(xi, eta):
        out = np.zeros((NFACES, len(eta), len(xi)))
        for f in range(NFACES):
            XI, ET = np.meshgrid(xi, eta, indexing="xy")
            q = face_point(f, XI, ET)
            q = q / np.linalg.norm(q, axis=-1, keepdims=True)
            e1, e2 = _basis_at(f, q)
            out[f] = np.sum(e1 * e2, axis=-1)
        return out

    def corner_mask(size_y, size_x, ty, tx):
        m = np.zeros((size_y, size_x), bool)
        for cid in range(4):
            ys = _block_slices(size_y, size_x, ty, cid)[0]
            xs = _block_slices(size_y, size_x, tx, cid)[1]
            m[ys, xs] = True
        return np.broadcast_to(m, (NFACES, size_y, size_x))

    return {
        # x-interfaces (v-points) [6, N, N+1]: corner-cell rows x the
        # interfaces flanking corner-block cells (h+1 outermost)
        "cosa_i": (cos_grid(ifc, cen), corner_mask(N, N + 1, h, h + 1)),
        "cosa_j": (cos_grid(cen, ifc), corner_mask(N + 1, N, h + 1, h)),
        "cosa_c": (cos_grid(cen, cen), corner_mask(N, N, h, h)),
        "cosa_cn": (cos_grid(ifc, ifc), corner_mask(N + 1, N + 1,
                                                    h + 1, h + 1)),
    }


def chart_corner_dw(n: int, h: int) -> np.ndarray:
    """Center->corner interpolation weight deltas consistent with the
    chart-corrected fills: grid._corner_interp_dw re-solved with the cell
    positions replaced by CHART positions in the corner L-regions (where
    apply_scalar moves the samples) and the target corner positions by
    chart corner points inside the corner squares.  Bit-identical to
    grid.corner_dw wherever no position changed."""
    from .grid import (_corner_interp_dw, _corner_positions_padded,
                       _gather_padded)

    spec = halo_spec(n, h)
    N = n + 2 * h
    cen, ifc = _chart_coords(n, h)
    c0, _ = _chart_coords(n, 0)
    centers = np.zeros((NFACES, n, n, 3))
    corners = np.zeros((NFACES, n + 1, n + 1, 3))
    for f in range(NFACES):
        CJ, CI = np.meshgrid(c0, c0, indexing="ij")
        centers[f] = face_point(f, CI, CJ)
        s0 = np.arange(n + 1) * (np.pi / 2) / n - np.pi / 4
        SJ, SI = np.meshgrid(s0, s0, indexing="ij")
        corners[f] = face_point(f, SI, SJ)
    pos_pad = _gather_padded(centers, spec)
    cpos = _corner_positions_padded(spec, corners)

    # blend chart positions into the L-regions (cells) ...
    for f in range(NFACES):
        for cid in range(4):
            Jt, It = _target_region(N, h, cid)
            XI = cen[It]
            ET = cen[Jt]
            q = face_point(f, XI, ET)
            pos_pad[f, Jt, It] = q / np.linalg.norm(q, axis=-1,
                                                    keepdims=True)
    # ... and the corner squares (corner points)
    W = h + 2
    for f in range(NFACES):
        for cid in range(4):
            isn, ise = _CORNERS[cid]
            rows = np.arange(N + 1 - (W + 1), N + 1) if isn \
                else np.arange(W + 1)
            cols = np.arange(N + 1 - (W + 1), N + 1) if ise \
                else np.arange(W + 1)
            J, I = np.meshgrid(rows, cols, indexing="ij")
            # only slots adjacent to halo cells (keep pure-interior bits)
            in_halo_j = (J > N - h) if isn else (J < h + 1)
            in_halo_i = (I > N - h) if ise else (I < h + 1)
            sel = in_halo_j | in_halo_i
            q = face_point(f, ifc[I[sel]], ifc[J[sel]])
            cpos[f, J[sel], I[sel]] = q / np.linalg.norm(
                q, axis=-1, keepdims=True)
    return np.asarray(_corner_interp_dw(cpos, pos_pad), np.float32)


# --------------------------------------------------------------------------
# application (torch, outside the kernels)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ChartCorners:
    """Device copy of the corner weights + the two apply operations."""

    h: int
    sc_dw_x: torch.Tensor   # [F, 4, W*W, P*P], F slots (6 faces)
    sc_dw_y: torch.Tensor
    sc_ex: torch.Tensor     # one-sided weights for derived fields
    st_w: torch.Tensor      # [F, 4, 2*W*W, S]
    st_mask: torch.Tensor   # [1 or F, 4, W*W] bool

    @classmethod
    def from_tables(cls, tables: ChartCornerTables, device) -> "ChartCorners":
        return cls(h=tables.h,
                   sc_dw_x=to_torch(tables.sc_dw_x, device),
                   sc_dw_y=to_torch(tables.sc_dw_y, device),
                   sc_ex=to_torch(tables.sc_ex, device),
                   st_w=to_torch(tables.st_w, device),
                   st_mask=torch.as_tensor(tables.st_mask[None],
                                           device=device))

    def for_slots(self, faces, gates) -> "ChartCorners":
        """The corrections of a sharded step's blocks: slot k takes face
        faces[k]'s weights, its corner c only where gates[k][c] is 1 (a
        block owns a cube corner only at the face's extremes).  A gated-off
        scalar corner has zero weights, an exact passthrough in deviation
        form; a gated-off A-grid corner keeps its values by the mask."""
        dev = self.sc_dw_x.device
        f = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
        g = to_torch(np.asarray(gates, np.float32), dev)      # [F, 4]
        scale = g[:, :, None, None]
        return ChartCorners(
            h=self.h, sc_dw_x=self.sc_dw_x[f] * scale,
            sc_dw_y=self.sc_dw_y[f] * scale, sc_ex=self.sc_ex[f] * scale,
            st_w=self.st_w[f], st_mask=self.st_mask[0][None]
            & (g[:, :, None] > 0))

    def apply_scalar(self, a: torch.Tensor, direction: str = "x"):
        """Resample the corner L-regions of a padded [F, Ny, Nx, ...] scalar
        onto the chart gridpoints, in deviation form (uniform fields stay
        bit-exact).  direction: 'x', 'y', or 'derived' (one-sided weights
        for fields whose L-region values are invalid)."""
        W_all = {"x": self.sc_dw_x, "y": self.sc_dw_y,
                 "derived": self.sc_ex}[direction]
        h = self.h
        Ny, Nx = a.shape[1], a.shape[2]
        P = _patch_width(h)
        W = h + 2
        out = a.clone()
        for cid in range(4):
            ys, xs = _corner_patch_slices(Ny, Nx, P, P, cid)
            ysq, xsq = _corner_patch_slices(Ny, Nx, W, W, cid)
            Wd = W_all[:, cid]                        # [F, WW, PP]
            patch = a[:, ys, xs]
            samp = patch.reshape((patch.shape[0], P * P) + patch.shape[3:])
            blk = out[:, ysq, xsq]
            base = blk.reshape((blk.shape[0], W * W) + blk.shape[3:])
            dev = samp[:, None] - base[:, :, None]   # [F, WW, PP, ...]
            corr = torch.einsum("fwp,fwp...->fw...", Wd, dev)
            out[:, ysq, xsq] = (base + corr).reshape(blk.shape)
        return out

    def apply_agrid(self, ua, va, pu, pv):
        """Overwrite the corner targets of the A-grid winds with the chart
        reconstruction from the padded D-grid winds; other slots of each
        W x W square keep their current values."""
        h = self.h
        Ny, Nx = ua.shape[1], ua.shape[2]
        P = _patch_width(h)
        W = h + 2
        WW = W * W
        ua_out, va_out = ua.clone(), va.clone()
        for cid in range(4):
            uys, uxs = _corner_patch_slices(Ny + 1, Nx, P + 1, P, cid)
            vys, vxs = _corner_patch_slices(Ny, Nx + 1, P, P + 1, cid)
            ysq, xsq = _corner_patch_slices(Ny, Nx, W, W, cid)
            up = pu[:, uys, uxs]
            vp = pv[:, vys, vxs]
            samp = torch.cat([
                up.reshape((up.shape[0], (P + 1) * P) + up.shape[3:]),
                vp.reshape((vp.shape[0], P * (P + 1)) + vp.shape[3:]),
            ], dim=1)                                 # [F, S, ...]
            Wd = self.st_w[:, cid]                    # [F, 2*WW, S]
            rec = torch.einsum("fws,fs...->fw...", Wd, samp)
            mshape = (self.st_mask.shape[0], WW) + (1,) * (rec.ndim - 2)
            mask = self.st_mask[:, cid].reshape(mshape)
            for comp, tgt in ((0, ua_out), (1, va_out)):
                blk = tgt[:, ysq, xsq]
                cur = blk.reshape((blk.shape[0], WW) + blk.shape[3:])
                new = torch.where(mask, rec[:, comp * WW:(comp + 1) * WW], cur)
                tgt[:, ysq, xsq] = new.reshape(blk.shape)
        return ua_out, va_out


def sharded_chart_for_subtile(chart: ChartCorners, layout, ranks):
    """The corrections of the blocks of `ranks` of a parallel.subtile
    layout, or None when the blocks are too small to hold the corner
    patches (bn < P - h): such layouts run without the corner correction,
    as the original's do."""
    if min(layout.bny, layout.bnx) < _patch_width(chart.h) - chart.h:
        return None
    faces, gates = [], []
    for d in ranks:
        fd, by, bx = layout.dev_coords(d)
        gate = [float(by == (layout.py - 1 if isn else 0)
                      and bx == (layout.px - 1 if ise else 0))
                for isn, ise in _CORNERS]
        for f in ([fd] if layout.face_sharded else range(NFACES)):
            faces.append(f)
            gates.append(gate)
    return chart.for_slots(faces, gates)

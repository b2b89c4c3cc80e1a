"""Frozen copy of geosongpu_tpu_torch/core/topology.py at commit f902e7ad95fb,
unchanged but for this note.

Cubed-sphere topology: face frames, edge adjacency, halo gather tables.

The port's own copy of geosongpu_tpu/core/topology.py (numpy only; held
to it bit for bit by tests/test_torch_core.py).  The topology is *static
data*: integer gather tables mapping every halo cell of every face to the
real owning (face, j, i) cell.  Applying a table is a plain gather
(parallel/halo.py applies them with index_select).

Construction
------------
* 6 faces, each an ``n x n`` equiangular gnomonic patch with local coords
  ``xi, eta in [-pi/4, pi/4]``; index order ``[face, j, i]`` (j ~ eta ~ y,
  i ~ xi ~ x).  A face is described by an orthonormal frame ``(c, a, b)``:
  sphere point of ``(xi, eta)`` is ``normalize(c + tan(xi) a + tan(eta) b)``.
* Edge adjacency (which face, which edge, flipped or not) is derived
  *numerically* by matching shared cube corners - no hand-maintained
  orientation table.
* Each edge crossing is represented as an affine index map ``(J', I') =
  M (J, I) + t`` with ``M`` a signed permutation.  Halo corner blocks
  (where 3 faces meet) are resolved by *composing two* edge maps; the
  composition order is direction-dependent (x-stencil lines continue
  through the S/N hop first, y-lines through the W/E hop first), which is
  the exact version of FV3's approximate `fill_corners` rotations.
* Vector components gather with ``M^T`` (signed permutations are
  orthogonal), and D-grid staggered winds (u on S/N cell edges, v on W/E)
  map onto the neighbor's u *or* v array depending on whether ``M`` swaps
  the axes - this reproduces what MPP's DGRID_NE vector exchange does in
  the Fortran world.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

NFACES = 6
EDGES = ("W", "E", "S", "N")

_X = np.array([1.0, 0.0, 0.0])
_Y = np.array([0.0, 1.0, 0.0])
_Z = np.array([0.0, 0.0, 1.0])
# (c, a, b): face center, local +x (xi), local +y (eta).
# Equator ring 0-3 (+X, +Y, -X, -Y), 4 = north (+Z), 5 = south (-Z).
FACE_FRAMES: Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], ...] = (
    (_X, _Y, _Z),
    (_Y, -_X, _Z),
    (-_X, -_Y, _Z),
    (-_Y, _X, _Z),
    (_Z, _Y, -_X),
    (-_Z, _Y, _X),
)


def face_point(face: int, xi, eta) -> np.ndarray:
    """Unit sphere point(s) for local equiangular coords on `face`."""
    c, a, b = FACE_FRAMES[face]
    xi = np.asarray(xi, dtype=np.float64)
    eta = np.asarray(eta, dtype=np.float64)
    p = c + np.tan(xi)[..., None] * a + np.tan(eta)[..., None] * b
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def _corner(face: int, sx: int, sy: int) -> np.ndarray:
    return face_point(face, sx * np.pi / 4, sy * np.pi / 4)


# Edge -> ordered (start, end) corner signs, by increasing along-edge coord.
_EDGE_CORNERS = {
    "W": ((-1, -1), (-1, +1)),
    "E": ((+1, -1), (+1, +1)),
    "S": ((-1, -1), (+1, -1)),
    "N": ((-1, +1), (+1, +1)),
}


@dataclass(frozen=True)
class EdgeLink:
    neighbor: int
    nedge: str
    parity: int  # +1: along-edge coords increase together, -1: opposed


def _round_pt(p: np.ndarray) -> Tuple[float, float, float]:
    q = np.round(p, 9) + 0.0
    return (float(q[0]), float(q[1]), float(q[2]))


@functools.lru_cache(maxsize=None)
def edge_table() -> Dict[Tuple[int, str], EdgeLink]:
    """Adjacency for all 24 (face, edge) pairs, derived from shared corners."""
    by_corners: Dict[frozenset, list] = {}
    endpoints = {}
    for f in range(NFACES):
        for e in EDGES:
            (sx0, sy0), (sx1, sy1) = _EDGE_CORNERS[e]
            p0 = _round_pt(_corner(f, sx0, sy0))
            p1 = _round_pt(_corner(f, sx1, sy1))
            endpoints[(f, e)] = (p0, p1)
            by_corners.setdefault(frozenset((p0, p1)), []).append((f, e))

    table: Dict[Tuple[int, str], EdgeLink] = {}
    for entries in by_corners.values():
        assert len(entries) == 2, f"edge shared by {len(entries)} faces: {entries}"
        (fa, ea), (fb, eb) = entries
        pa0, pa1 = endpoints[(fa, ea)]
        pb0, pb1 = endpoints[(fb, eb)]
        parity = +1 if pa0 == pb0 else -1
        assert (pa0 == pb0 and pa1 == pb1) or (pa0 == pb1 and pa1 == pb0)
        table[(fa, ea)] = EdgeLink(fb, eb, parity)
        table[(fb, eb)] = EdgeLink(fa, ea, parity)
    return table


# ---------------------------------------------------------------------------
# Affine index maps across edges
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Affine:
    """(J', I') = M @ (J, I) + t into face `g`'s index plane."""

    g: int
    M: Tuple[Tuple[int, int], Tuple[int, int]]
    t: Tuple[int, int]

    def apply(self, J, I):
        (a, b), (c, d) = self.M
        tj, ti = self.t
        return a * J + b * I + tj, c * J + d * I + ti

    def compose_after(self, first: "Affine") -> "Affine":
        """self o first (apply `first`, then `self`)."""
        A = np.array(self.M)
        B = np.array(first.M)
        M = A @ B
        t = A @ np.array(first.t) + np.array(self.t)
        return Affine(self.g, ((int(M[0, 0]), int(M[0, 1])), (int(M[1, 0]), int(M[1, 1]))),
                      (int(t[0]), int(t[1])))

    @property
    def swap(self) -> bool:
        return self.M[0][0] == 0

    def gather_signs(self) -> Tuple[int, int]:
        """(sign_y, sign_x) applied to neighbor components when pulling a
        vector into our frame: v_ours = M^T v_theirs (signed permutation).
        sign_x multiplies whichever neighbor component feeds our x."""
        Mt = np.array(self.M).T
        # our (y,x) components = Mt @ their (y,x)
        sy = int(Mt[0, 0] + Mt[0, 1])  # exactly one is nonzero
        sx = int(Mt[1, 0] + Mt[1, 1])
        return sy, sx


@functools.lru_cache(maxsize=None)
def edge_affine(f: int, e: str, n: int) -> Affine:
    """Affine map from face f's virtual index plane, crossing edge `e`,
    into the neighbor's real index plane.  Derived by symbolically pushing
    (depth, along) through the link; valid for any virtual (J, I) beyond
    edge `e` (including corner compositions)."""
    link = edge_table()[(f, e)]
    g, e2, par = link.neighbor, link.nedge, link.parity

    # (depth, along) as affine functions of (J, I)
    # depth = how far beyond the edge; along = our along-edge coordinate
    if e == "E":
        dep = (0, 1, -n)   # coefficients (cJ, cI, const)
        alo = (1, 0, 0)
    elif e == "W":
        dep = (0, -1, -1)
        alo = (1, 0, 0)
    elif e == "N":
        dep = (1, 0, -n)
        alo = (0, 1, 0)
    else:  # S
        dep = (-1, 0, -1)
        alo = (0, 1, 0)

    # neighbor along-edge coordinate
    if par == +1:
        alo2 = alo
    else:
        alo2 = (-alo[0], -alo[1], n - 1 - alo[2])

    # (J', I') from (depth, along2) per neighbor edge e2
    # W: (J', I') = (along2, depth); E: (along2, n-1-depth)
    # S: (depth, along2);            N: (n-1-depth, along2)
    def lin(c):  # unpack
        return np.array([c[0], c[1]]), c[2]

    dvec, dconst = lin(dep)
    avec, aconst = lin(alo2)
    if e2 == "W":
        Jv, Jc = avec, aconst
        Iv, Ic = dvec, dconst
    elif e2 == "E":
        Jv, Jc = avec, aconst
        Iv, Ic = -dvec, n - 1 - dconst
    elif e2 == "S":
        Jv, Jc = dvec, dconst
        Iv, Ic = avec, aconst
    else:  # N
        Jv, Jc = -dvec, n - 1 - dconst
        Iv, Ic = avec, aconst

    M = ((int(Jv[0]), int(Jv[1])), (int(Iv[0]), int(Iv[1])))
    return Affine(g, M, (int(Jc), int(Ic)))


def _owner(n: int, f: int, J: np.ndarray, I: np.ndarray, order: str):
    """Resolve virtual (possibly out-of-face) cell coords to real owners.

    order='x': resolve the S/N crossing first (x-stencil lines continue
    through the S/N halo rows), then W/E.  order='y': W/E first.
    Returns (face, j, i, Affine-per-region list applied) as arrays plus the
    composed signed-permutation transforms (swap, sign_y, sign_x).
    """
    J = np.asarray(J)
    I = np.asarray(I)
    face = np.full(J.shape, f, dtype=np.int32)
    j = J.astype(np.int64).copy()
    i = I.astype(np.int64).copy()
    swap = np.zeros(J.shape, dtype=bool)
    sy = np.ones(J.shape, dtype=np.int8)
    sx = np.ones(J.shape, dtype=np.int8)

    first_axes = ("S", "N", "W", "E") if order == "x" else ("W", "E", "S", "N")

    for _hop in range(2):
        for e in first_axes:
            if e == "S":
                sel = j < 0
            elif e == "N":
                sel = j >= n
            elif e == "W":
                sel = i < 0
            else:
                sel = i >= n
            # only apply to points still attributed to a face they're outside of
            if not sel.any():
                continue
            # snapshot before this edge pass: a point hopped to face g' must
            # not be re-hopped when the g-loop reaches g'
            face0 = face.copy()
            j0, i0 = j.copy(), i.copy()
            for g in range(NFACES):
                m = sel & (face0 == g)
                if not m.any():
                    continue
                aff = edge_affine(g, e, n)
                J2, I2 = aff.apply(j0[m], i0[m])
                j[m], i[m] = J2, I2
                face[m] = aff.g
                gsy, gsx = aff.gather_signs()
                # Compose total transform T = T_old o T_hop, where each T is a
                # signed permutation tracked as (swap, sy, sx) of
                # v_ours = T v_theirs.  T_old's y-row reads T_hop's y-row when
                # not swapped, else its x-row:
                #   sy_tot = sy_old * (sx_hop if swap_old else sy_hop)
                #   sx_tot = sx_old * (sy_hop if swap_old else sx_hop)
                #   swap_tot = swap_old XOR swap_hop
                w1 = swap[m]
                sy[m] = (sy[m] * np.where(w1, gsx, gsy)).astype(np.int8)
                sx[m] = (sx[m] * np.where(w1, gsy, gsx)).astype(np.int8)
                if aff.swap:
                    swap[m] = ~swap[m]
        # points needing a second crossing (corner blocks whose first hop
        # left them outside the new face) are resolved by the second pass
    assert (j >= 0).all() and (j < n).all() and (i >= 0).all() and (i < n).all(), (
        "unresolved virtual cells; halo too deep (h > n?)"
    )
    return face, j.astype(np.int32), i.astype(np.int32), swap, sy, sx


@dataclass(frozen=True)
class HaloSpec:
    """Static halo gather tables.  Padded cell layout [6, N, N], N = n+2h,
    index [face, h+j, h+i].  Two cell tables exist because the 8 cube-corner
    halo blocks are direction-dependent (see module docstring); they agree
    everywhere else.

    gidx_*: flat index into a [6*n*n] cell array.
    vswap/vsy/vsx_*: signed-permutation transform for cell-centered vectors:
        ours_y = vsy * theirs[y or x], ours_x = vsx * theirs[x or y],
        with the swap flag choosing the source component.
    u_idx/u_sgn: for D-grid u [6, N+1, N]: flat index into the concatenation
        [u.flat (6*(n+1)*n), v.flat (6*n*(n+1))]; sign multiplier.
    v_idx/v_sgn: same for D-grid v [6, N, N+1].
    corner_mask: True on the 4 h x h corner blocks of each face (where the
        two tables differ and geometry is approximate).
    """

    n: int
    h: int
    gidx_x: np.ndarray
    gidx_y: np.ndarray
    vswap_x: np.ndarray
    vsy_x: np.ndarray
    vsx_x: np.ndarray
    vswap_y: np.ndarray
    vsy_y: np.ndarray
    vsx_y: np.ndarray
    u_idx: np.ndarray
    u_sgn: np.ndarray
    u_sgn_n: np.ndarray
    v_idx: np.ndarray
    v_sgn: np.ndarray
    v_sgn_n: np.ndarray
    corner_mask: np.ndarray
    # raw cell tables (for building metric/position paddings in numpy)
    src_face_x: np.ndarray
    src_j_x: np.ndarray
    src_i_x: np.ndarray


@functools.lru_cache(maxsize=None)
def halo_spec(n: int, h: int) -> HaloSpec:
    assert h <= n, "halo wider than a face"
    N = n + 2 * h
    Jv, Iv = np.meshgrid(np.arange(N) - h, np.arange(N) - h, indexing="ij")
    Jv = np.broadcast_to(Jv, (NFACES, N, N))
    Iv = np.broadcast_to(Iv, (NFACES, N, N))

    tables = {}
    for order in ("x", "y"):
        face = np.zeros((NFACES, N, N), dtype=np.int32)
        j = np.zeros((NFACES, N, N), dtype=np.int32)
        i = np.zeros((NFACES, N, N), dtype=np.int32)
        sw = np.zeros((NFACES, N, N), dtype=bool)
        sy = np.zeros((NFACES, N, N), dtype=np.int8)
        sx = np.zeros((NFACES, N, N), dtype=np.int8)
        for f in range(NFACES):
            face[f], j[f], i[f], sw[f], sy[f], sx[f] = _owner(n, f, Jv[f], Iv[f], order)
        gidx = (face * n + j) * n + i
        tables[order] = (gidx.astype(np.int32), sw, sy, sx, face, j, i)

    corner_mask = np.zeros((NFACES, N, N), dtype=bool)
    corner_mask[:, :h, :h] = True
    corner_mask[:, :h, h + n:] = True
    corner_mask[:, h + n:, :h] = True
    corner_mask[:, h + n:, h + n:] = True

    # ------------------------------------------------------------------
    # staggered D-grid tables
    # u[face, j, i]: x-wind on the eta-interface j (S edge of cell (j, i)),
    #   j in [0, n], i in [0, n).  Padded [6, N+1, N].
    # v[face, j, i]: y-wind on xi-interface i (W edge of cell (j, i)),
    #   j in [0, n), i in [0, n+1).  Padded [6, N, N+1].
    # ------------------------------------------------------------------
    u_off = 0
    v_off = NFACES * (n + 1) * n  # v entries start here in the concat-flat

    def u_flat(face, j, i):
        return u_off + (face * (n + 1) + j) * n + i

    def v_flat(face, j, i):
        return v_off + (face * n + j) * (n + 1) + i

    # u points ------------------------------------------------------------
    # A u-point at padded interface row PJ belongs to cell (PJ, PI) as its S
    # edge, except PJ == N which is the N edge of cell N-1.  The owner's copy
    # lives in its u array (no axis swap) or v array (swap), on the side
    # selected by forward-mapping our -y (S) / +y (N) displacement: their
    # side sign = side * sy (no swap: their y side; swap: their x side) -
    # derivable from M = T^T, see module docstring.
    u_idx = np.zeros((NFACES, N + 1, N), dtype=np.int32)
    u_sgn = np.ones((NFACES, N + 1, N), dtype=np.int8)      # tangential (x-comp)
    u_sgn_n = np.ones((NFACES, N + 1, N), dtype=np.int8)    # normal (y-comp, C-grid)
    PJ, PI = np.meshgrid(np.arange(N + 1), np.arange(N), indexing="ij")
    cellJ = np.minimum(PJ, N - 1) - h
    cellI = PI - h
    side = np.where(PJ != N, -1, +1)  # -1: S edge of owner cell, +1: N edge
    u_interior = (PJ >= h) & (PJ <= h + n) & (PI >= h) & (PI < h + n)
    for f in range(NFACES):
        face, j, i, sw, sy, sx = _owner(n, f, cellJ, cellI, "x")
        s_edge = side * sy  # side in the owner's frame
        tgtJ = j + ((s_edge + 1) // 2)
        tgtI = i + ((s_edge + 1) // 2)
        idx = np.where(~sw, u_flat(face, tgtJ, i), v_flat(face, j, tgtI))
        self_idx = u_flat(f, PJ - h, PI - h)
        u_idx[f] = np.where(u_interior, self_idx, idx)
        u_sgn[f] = np.where(u_interior, 1, sx)
        u_sgn_n[f] = np.where(u_interior, 1, sy)

    # v points ------------------------------------------------------------
    v_idx = np.zeros((NFACES, N, N + 1), dtype=np.int32)
    v_sgn = np.ones((NFACES, N, N + 1), dtype=np.int8)      # tangential (y-comp)
    v_sgn_n = np.ones((NFACES, N, N + 1), dtype=np.int8)    # normal (x-comp, C-grid)
    PJ, PI = np.meshgrid(np.arange(N), np.arange(N + 1), indexing="ij")
    cellJ = PJ - h
    cellI = np.minimum(PI, N - 1) - h
    side = np.where(PI != N, -1, +1)  # -1: W edge of owner cell, +1: E edge
    v_interior = (PI >= h) & (PI <= h + n) & (PJ >= h) & (PJ < h + n)
    for f in range(NFACES):
        face, j, i, sw, sy, sx = _owner(n, f, cellJ, cellI, "y")
        s_edge = side * sx
        tgtI = i + ((s_edge + 1) // 2)
        tgtJ = j + ((s_edge + 1) // 2)
        idx = np.where(~sw, v_flat(face, j, tgtI), u_flat(face, tgtJ, i))
        self_idx = v_flat(f, PJ - h, PI - h)
        v_idx[f] = np.where(v_interior, self_idx, idx)
        v_sgn[f] = np.where(v_interior, 1, sy)
        v_sgn_n[f] = np.where(v_interior, 1, sx)

    gx, swx, syx, sxx, fx, jx, ix = tables["x"]
    gy, swy, syy, sxy, _, _, _ = tables["y"]
    return HaloSpec(
        n=n, h=h,
        gidx_x=gx, gidx_y=gy,
        vswap_x=swx, vsy_x=syx, vsx_x=sxx,
        vswap_y=swy, vsy_y=syy, vsx_y=sxy,
        u_idx=u_idx, u_sgn=u_sgn, u_sgn_n=u_sgn_n,
        v_idx=v_idx, v_sgn=v_sgn, v_sgn_n=v_sgn_n,
        corner_mask=corner_mask,
        src_face_x=fx, src_j_x=jx, src_i_x=ix,
    )


# ---------------------------------------------------------------------------
# Shared-edge twins (staggered boundary entries duplicated across faces)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def edge_twins(n: int):
    """Every face-boundary staggered wind entry exists TWICE in the global
    (u [6, n+1, n], v [6, n, n+1]) arrays - once per adjacent face.  Both
    copies are prognosed independently and stay equal only through
    identical stencils + rounding ("shared-edge drift").  This builds the
    twin pairing numerically: boundary entries are matched by physical
    edge-midpoint position, and the relative sign is the dot product of
    the local tangent directions (+-1 exactly, since tangents along a
    shared edge are colinear).

    Returns (idx_a, idx_b, sign): flat indices into concat(u.flat, v.flat)
    and the sign such that value_b == sign * value_a physically."""
    u_count = NFACES * (n + 1) * n
    dxi = (np.pi / 2) / n
    cen = (np.arange(n) + 0.5) * dxi - np.pi / 4
    edge = np.array([-np.pi / 4, np.pi / 4])

    def tangent(f, xi, eta, which):
        c_, a_, b_ = FACE_FRAMES[f]
        t1 = np.tan(xi)[..., None]
        t2 = np.tan(eta)[..., None]
        p = c_ + t1 * a_ + t2 * b_
        nrm2 = np.sum(p * p, axis=-1, keepdims=True)
        vec = a_ if which == "x" else b_
        e = (vec - np.sum(vec * p, -1, keepdims=True) * p / nrm2)
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    entries = []  # (pos, dir, flat_idx)
    for f in range(NFACES):
        # u rows j=0 (eta=-pi/4) and j=n: positions (xi=cen, eta=edge)
        for jj, eta in ((0, edge[0]), (n, edge[1])):
            xi = cen
            pos = face_point(f, xi, np.full_like(xi, eta))
            dirs = tangent(f, xi, np.full_like(xi, eta), "x")
            for i in range(n):
                flat = (f * (n + 1) + jj) * n + i
                entries.append((pos[i], dirs[i], flat))
        # v cols i=0 and i=n: positions (xi=edge, eta=cen)
        for ii, xi in ((0, edge[0]), (n, edge[1])):
            eta = cen
            pos = face_point(f, np.full_like(eta, xi), eta)
            dirs = tangent(f, np.full_like(eta, xi), eta, "y")
            for j in range(n):
                flat = u_count + (f * n + j) * (n + 1) + ii
                entries.append((pos[j], dirs[j], flat))

    by_pos = {}
    for pos, d, flat in entries:
        key = tuple(np.round(pos, 9))
        by_pos.setdefault(key, []).append((d, flat))
    idx_a, idx_b, sgn = [], [], []
    for key, pair in by_pos.items():
        assert len(pair) == 2, f"edge midpoint shared by {len(pair)}"
        (da, fa), (db, fb) = pair
        dot = float(np.dot(da, db))
        assert abs(abs(dot) - 1.0) < 1e-9, dot
        idx_a.append(fa)
        idx_b.append(fb)
        sgn.append(int(np.round(dot)))
    return (np.asarray(idx_a), np.asarray(idx_b),
            np.asarray(sgn, np.int8))

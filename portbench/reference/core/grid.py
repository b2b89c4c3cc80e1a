"""Frozen copy of geosongpu_tpu_torch/core/grid.py at commit f902e7ad95fb,
unchanged but for this note.

Equiangular gnomonic cubed-sphere geometry and metric terms.

Builds the static metric arrays the finite-volume solver needs, padded with
`h` halo cells of *true neighbor-face geometry* using the gather tables from
`topology.py` (the same trick FV3 uses: halo metric arrays carry the
neighbor's real dx/dy/area so stencils can run straight across face edges).

The port's own copy of geosongpu_tpu/core/grid.py (numpy only; every
array of build_grid is held to it bit for bit by tests/test_torch_core.py).

Notes:
* Direction-dependent metric arrays (dx vs dy) swap under the halo gather
  when the neighbor face's axes are rotated relative to ours
  (HaloSpec.vec_swap).
* The four h x h halo corner blocks have no unique owner on a cubed sphere;
  they are filled with nearest-edge values and masked.  Stencils that need
  corner data use `fill_corners_*` from parallel/halo.py.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .topology import NFACES, HaloSpec, halo_spec, face_point

RADIUS = 6.3712e6  # m, GFDL/GEOS Earth radius
OMEGA = 7.292e-5  # 1/s
GRAV = 9.80665
RDGAS = 287.04
CP_AIR = 1004.64
KAPPA = RDGAS / CP_AIR


def _local_coords(n: int, h: int = 0):
    """Equiangular coords: centers (n+2h) and interfaces (n+2h+1) incl. halo."""
    dxi = (np.pi / 2) / n
    c = (np.arange(-h, n + h) + 0.5) * dxi - np.pi / 4
    s = np.arange(-h, n + h + 1) * dxi - np.pi / 4
    return c, s


def _gc_dist(p, q):
    """Great-circle distance (radius 1) between unit vectors (broadcast)."""
    cross = np.linalg.norm(np.cross(p, q), axis=-1)
    dot = np.sum(p * q, axis=-1)
    return np.arctan2(cross, dot)


def _spherical_quad_area(p00, p10, p11, p01):
    """Area (radius 1) of a spherical quadrilateral via corner excess."""

    def corner_angle(a, b, c):
        # angle at b between arcs b->a and b->c
        ta = a - b * np.sum(a * b, axis=-1, keepdims=True)
        tc = c - b * np.sum(c * b, axis=-1, keepdims=True)
        ta /= np.linalg.norm(ta, axis=-1, keepdims=True)
        tc /= np.linalg.norm(tc, axis=-1, keepdims=True)
        return np.arccos(np.clip(np.sum(ta * tc, axis=-1), -1.0, 1.0))

    ang = (
        corner_angle(p01, p00, p10)
        + corner_angle(p00, p10, p11)
        + corner_angle(p10, p11, p01)
        + corner_angle(p11, p01, p00)
    )
    return ang - 2 * np.pi


@dataclass(frozen=True)
class Grid:
    """Static cubed-sphere metric data (numpy float32/float64 at build; the
    model moves what it needs to the device once, in padded_metrics).

    Shapes use N = n + 2h (padded) unless noted; index order [face, j, i].
    """

    n: int
    h: int
    spec: HaloSpec
    # positions
    lat: np.ndarray  # [6, N, N] cell-center latitude (rad), halo-true
    lon: np.ndarray  # [6, N, N]
    # metrics (meters / m^2), halo-true except corner blocks
    area: np.ndarray  # [6, N, N] cell area
    rarea: np.ndarray  # 1/area
    dx: np.ndarray  # [6, N+1, N] length of cell edges along x (at S/N edges, j-interfaces)
    dy: np.ndarray  # [6, N, N+1] length of cell edges along y (at W/E edges, i-interfaces)
    dxc: np.ndarray  # [6, N, N+1] center-to-center distance across W/E interfaces
    dyc: np.ndarray  # [6, N+1, N] center-to-center distance across S/N interfaces
    fcor: np.ndarray  # [6, N, N] Coriolis parameter at centers
    fcor_c: np.ndarray  # [6, N+1, N+1] Coriolis at cell corners (for D-grid vorticity)
    corner_mask: np.ndarray  # [6, N, N] True on unownable halo corner blocks
    # grid non-orthogonality (the equiangular gnomonic axes are not
    # perpendicular away from face centers): cos of the angle between the
    # local xi/eta directions at the staggered flux points, halo-true
    # (cosa flips sign under odd frame maps: padded with sgn_t*sgn_n)
    cosa_i: np.ndarray  # [6, N, N+1] at x-interfaces (v-point locations)
    rsina_i: np.ndarray  # 1/sqrt(1-cosa_i^2)
    cosa_j: np.ndarray  # [6, N+1, N] at y-interfaces (u-point locations)
    rsina_j: np.ndarray
    cosa_c: np.ndarray   # [6, N, N] at cell centers (pseudo-scalar padded)
    rsin2_c: np.ndarray  # 1/sin^2 at centers
    cosa_cn: np.ndarray  # [6, N+1, N+1] at cell corners
    rsin2_cn: np.ndarray
    # halo wind-component basis correction [6, N, N] each: halo cells store
    # the NEIGHBOR's covariant components (signed-permutation relabeled by
    # the fill); stencils that average them with interior values mix bases
    # across the face-edge kink - an O(1) error in the C-grid advective
    # winds (measured ~0.4-2.5 m/s on the balanced jet at c24, vs 1e-3
    # interior; scripts/edge_probe.py).  These matrices re-express the
    # stored components in OUR face's analytically-extended basis at the
    # true cell-center point:  (ua, va)_ours = R (ua, va)_stored.
    # Stored as deltas from identity (dr11 = r11 - 1, etc., exact zeros in
    # the interior) so applying them preserves interior values bit-exactly.
    dr11: np.ndarray
    r12: np.ndarray
    r21: np.ndarray
    dr22: np.ndarray
    # halo A-grid resampling onto extended-chart gridpoints [6, N, N] each:
    # after the basis rotation, W/E-halo samples sit shifted ALONG the
    # edge (exact in xi, off in eta) and S/N-halo mirrored; one static
    # 3-point Lagrange resample per off-grid coordinate re-attaches them
    # to our gridpoints.  Stored as deltas (identity = exact zeros in the
    # interior):  a += jwm (a[j-1] - a) + jwp (a[j+1] - a), then along i
    # (deviation form: bit-zero on uniform fields; w0 = 1 - wm - wp).
    jwm: np.ndarray
    jwp: np.ndarray
    iwm: np.ndarray
    iwp: np.ndarray
    # extended-CHART center-to-center spacings [6, N, N+1] / [6, N+1, N]:
    # distances between our chart's gridpoints (where resampled samples
    # live), for C-grid gradients; equals dxc/dyc in the interior but
    # differs across face edges, where dxc follows the physical
    # (kinked) center chord instead of the chart's xi/eta line
    dxc_c: np.ndarray
    dyc_c: np.ndarray
    # geometry-exact center->corner interpolation corrections [4, 6, N+1, N+1]:
    # weight deltas (w_k - 1/4) of the min-norm linear-exact interpolation of
    # the 4 surrounding padded centers onto the TRUE corner point (order
    # 00, 01, 10, 11 = SW, SE, NW, NE cell).  Zero where the plain 4-point
    # average is already linear-exact; O(1) corrections across the face-edge
    # metric kinks and at the 8 three-cell cube corners (FV3's one-sided
    # a2b/fill_corners role, precomputed as static data)
    corner_dw: np.ndarray
    # STAGGERED-halo resampling weights (same deviation-form contract as
    # jwm/iwm, but for scalar-like fields living on the u-grid
    # [6, N+1, N] and v-grid [6, N, N+1]): halo staggered samples sit at
    # the NEIGHBOR's staggered points, shifted along the edge in our
    # extended chart.  Consumers: the corner-dual damping divergence
    # (dycore/sw.damping_normal_fields), whose raw-halo form had a flat
    # ~2e-4 1/s spurious divergence along face edges on a smooth
    # solid-body flow (5 orders above interior)
    su_jwm: np.ndarray
    su_jwp: np.ndarray
    su_iwm: np.ndarray
    su_iwp: np.ndarray
    sv_jwm: np.ndarray
    sv_jwp: np.ndarray
    sv_iwm: np.ndarray
    sv_iwp: np.ndarray

    @property
    def interior(self):
        """Slice selecting the interior of a padded [.., N, N, ..] array."""
        h, n = self.h, self.n
        return (slice(None), slice(h, h + n), slice(h, h + n))


def _gather_padded(vals_ffi: np.ndarray, spec: HaloSpec) -> np.ndarray:
    """Gather an unpadded [6, n, n] per-cell array into padded [6, N, N]
    (corner blocks use the x-order table; metric fields are smooth enough
    that the x/y corner difference is immaterial for geometry)."""
    n = spec.n
    flat = vals_ffi.reshape(NFACES * n * n, *vals_ffi.shape[3:])
    return flat[spec.gidx_x]


def _corner_positions_padded(spec: HaloSpec, corners: np.ndarray) -> np.ndarray:
    """Exact positions of every padded corner slot [6, N+1, N+1, 3].

    Corner slot (J, I) is the SW corner of padded cell (J, I) (row/col N:
    the N/E corner of the last cell).  The owning cell comes from the
    x-order halo table; our (-1/2, -1/2) corner displacement maps into the
    owner's frame through the transposed signed permutation (signed perms
    are orthogonal), selecting which of the owner's 4 exact corners this
    slot is.  Unlike averaged approximations this is exact arbitrarily deep
    into the halo, including inside the cube-corner blocks."""
    n, h = spec.n, spec.h
    N = n + 2 * h
    J, I = np.meshgrid(np.arange(N + 1), np.arange(N + 1), indexing="ij")
    cJ = np.minimum(J, N - 1)
    cI = np.minimum(I, N - 1)
    oy = (J - cJ) - 0.5  # -0.5 (SW corner of the cell) or +0.5 (last row)
    ox = (I - cI) - 0.5
    cpos = np.zeros((NFACES, N + 1, N + 1, 3))
    for f in range(NFACES):
        f2 = spec.src_face_x[f, cJ, cI]
        j2 = spec.src_j_x[f, cJ, cI]
        i2 = spec.src_i_x[f, cJ, cI]
        sw = spec.vswap_x[f, cJ, cI]
        sy = spec.vsy_x[f, cJ, cI].astype(np.float64)
        sx = spec.vsx_x[f, cJ, cI].astype(np.float64)
        # theirs = T^T ours (module docstring of topology.py)
        ty = np.where(sw, sx * ox, sy * oy)
        tx = np.where(sw, sy * oy, sx * ox)
        jj = j2 + (ty > 0)
        ii = i2 + (tx > 0)
        cpos[f] = corners[f2, jj, ii]
    # self-check: the interior block must reproduce the exact face corners
    assert np.allclose(cpos[:, h:h + n + 1, h:h + n + 1], corners,
                       atol=1e-12), "corner position table inconsistent"
    return cpos


def _corner_interp_dw(cpos: np.ndarray, pos_pad: np.ndarray) -> np.ndarray:
    """Min-norm linear-exact center->corner interpolation weight deltas.

    For each corner point c with surrounding padded cell centers p_k
    (k = 00, 01, 10, 11, edge-clamped like sw._center_to_corner_w), solve
        min ||w||^2  s.t.  sum w = 1,  sum w (p_k - c) . t_{1,2} = 0
    in the tangent plane at c: the unique weights closest to the plain
    average that interpolate linear fields exactly.  On a symmetric
    (interior-like) cross this IS the plain average; across face-edge
    kinks and at the 8 cube corners (duplicated diagonal cell) it yields
    the one-sided correction FV3 hand-codes in a2b_ord4/fill_corners.
    Returns dw = w - 1/4, shape [4, 6, N+1, N+1], zeros snapped."""
    pp = np.pad(pos_pad, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    P = np.stack([pp[:, :-1, :-1], pp[:, :-1, 1:],
                  pp[:, 1:, :-1], pp[:, 1:, 1:]], axis=-2)  # [6,N+1,N+1,4,3]
    d = P - cpos[..., None, :]
    z = cpos
    helper = np.where(np.abs(z[..., :1]) < 0.9,
                      np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]))
    t1 = np.cross(z, helper)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(z, t1)
    x = np.sum(d * t1[..., None, :], -1)  # [6, N+1, N+1, 4]
    y = np.sum(d * t2[..., None, :], -1)
    s = np.maximum(np.mean(np.hypot(x, y), axis=-1, keepdims=True), 1e-30)
    x = x / s
    y = y / s
    A = np.stack([np.ones_like(x), x, y], axis=-2)  # [.., 3, 4]
    M = A @ np.swapaxes(A, -1, -2)
    det = np.linalg.det(M)
    ok = np.abs(det) > 1e-9
    Msafe = np.where(ok[..., None, None], M, np.eye(3))
    b = np.zeros(M.shape[:-1])
    b[..., 0] = 1.0
    lam = np.linalg.solve(Msafe, b[..., None])
    w = (np.swapaxes(A, -1, -2) @ lam)[..., 0]
    good = ok[..., None] & (np.abs(w).max(-1, keepdims=True) < 3.0)
    w = np.where(good, w, 0.25)
    dw = w - 0.25
    dw[np.abs(dw) < 1e-7] = 0.0
    return np.moveaxis(dw, -1, 0)


def _gather_staggered(u_like: np.ndarray, v_like: np.ndarray, spec: HaloSpec):
    """Pad edge-located (staggered) positive scalars - e.g. edge lengths -
    using the D-grid tables *without* the sign: our halo x-edge may be the
    neighbor's y-edge, and the staggered tables encode exactly that."""
    flat = np.concatenate([u_like.reshape(-1), v_like.reshape(-1)])
    return flat[spec.u_idx], flat[spec.v_idx]


@functools.lru_cache(maxsize=8)
def build_grid(n: int, h: int = 3) -> Grid:
    spec = halo_spec(n, h)
    N = n + 2 * h
    c, s = _local_coords(n, 0)

    # --- per-face unpadded geometry -------------------------------------
    # corner positions [6, n+1, n+1, 3]
    corners = np.zeros((NFACES, n + 1, n + 1, 3))
    centers = np.zeros((NFACES, n, n, 3))
    for f in range(NFACES):
        SJ, SI = np.meshgrid(s, s, indexing="ij")
        corners[f] = face_point(f, SI, SJ)
        CJ, CI = np.meshgrid(c, c, indexing="ij")
        centers[f] = face_point(f, CI, CJ)

    area_c = _spherical_quad_area(
        corners[:, :-1, :-1],
        corners[:, :-1, 1:],
        corners[:, 1:, 1:],
        corners[:, 1:, :-1],
    ) * RADIUS**2
    # staggered edge lengths: x-directed edges at eta-interfaces (u-points,
    # [6, n+1, n]) and y-directed edges at xi-interfaces (v-points,
    # [6, n, n+1]) - padded exactly via the staggered halo tables
    dx_stag = _gc_dist(corners[:, :, :-1], corners[:, :, 1:]) * RADIUS
    dy_stag = _gc_dist(corners[:, :-1, :], corners[:, 1:, :]) * RADIUS

    # --- padded arrays ---------------------------------------------------
    pos_pad = _gather_padded(centers, spec)  # [6,N,N,3] true neighbor centers
    area_pad = _gather_padded(area_c, spec)
    dx_pad, dy_pad = _gather_staggered(dx_stag, dy_stag, spec)

    # center-to-center distances (computed from true positions; exact even
    # across face edges).  At the 8 cube corners the diagonal "fourth cell"
    # does not exist, so adjacent padded slots can hold the *same* physical
    # cell -> zero distance; clamp to half a cell so Courant numbers stay
    # finite (those interfaces carry no interior-reaching fluxes).
    cell = (np.pi / 2) / n * RADIUS
    dxc = np.zeros((NFACES, N, N + 1))
    dxc[:, :, 1:N] = _gc_dist(pos_pad[:, :, :-1], pos_pad[:, :, 1:]) * RADIUS
    dxc[:, :, 0] = dxc[:, :, 1]
    dxc[:, :, N] = dxc[:, :, N - 1]
    dxc = np.maximum(dxc, 0.5 * cell)
    dyc = np.zeros((NFACES, N + 1, N))
    dyc[:, 1:N, :] = _gc_dist(pos_pad[:, :-1, :], pos_pad[:, 1:, :]) * RADIUS
    dyc[:, 0, :] = dyc[:, 1, :]
    dyc[:, N, :] = dyc[:, N - 1, :]
    dyc = np.maximum(dyc, 0.5 * cell)

    lat = np.arcsin(np.clip(pos_pad[..., 2], -1.0, 1.0))
    lon = np.arctan2(pos_pad[..., 1], pos_pad[..., 0])
    fcor = 2 * OMEGA * pos_pad[..., 2]

    # --- basis directions of OUR face's analytically-extended chart ------
    # The equiangular gnomonic chart extends smoothly past the face edge
    # (tan is defined beyond pi/4); every wind-carrying stencil treats the
    # padded array as samples of ONE chart, so all basis-angle metrics are
    # evaluated in that chart at the TRUE physical point of each slot.
    from .topology import FACE_FRAMES

    def _basis_at(f, q):
        """Unit tangent vectors (e1, e2) of face f's chart at unit
        point(s) q [..., 3] (front hemisphere of the face)."""
        _, a_, b_ = FACE_FRAMES[f]
        e1 = a_ - np.sum(a_ * q, -1, keepdims=True) * q
        e2 = b_ - np.sum(b_ * q, -1, keepdims=True) * q
        e1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
        e2 = e2 / np.linalg.norm(e2, axis=-1, keepdims=True)
        return e1, e2

    def _cos_at(f, q):
        e1, e2 = _basis_at(f, q)
        return np.sum(e1 * e2, axis=-1)

    # true flux-point positions: x-interface (v-point / W-E edge midpoint)
    # and y-interface (u-point / S-N edge midpoint), padded exactly via the
    # staggered tables (points are orientation-free)
    ymid = corners[:, :, :-1] + corners[:, :, 1:]
    ymid /= np.linalg.norm(ymid, axis=-1, keepdims=True)   # u-points [6,n+1,n,3]
    xmid = corners[:, :-1, :] + corners[:, 1:, :]
    xmid /= np.linalg.norm(xmid, axis=-1, keepdims=True)   # v-points [6,n,n+1,3]
    upos = np.stack([_gather_staggered(ymid[..., k], xmid[..., k], spec)[0]
                     for k in range(3)], axis=-1)
    vpos = np.stack([_gather_staggered(ymid[..., k], xmid[..., k], spec)[1]
                     for k in range(3)], axis=-1)
    cosa_i_pad = np.zeros((NFACES, N, N + 1))
    cosa_j_pad = np.zeros((NFACES, N + 1, N))
    cosa_c = np.zeros((NFACES, N, N))
    cpos = _corner_positions_padded(spec, corners)
    cosa_cn = np.zeros((NFACES, N + 1, N + 1))
    for f in range(NFACES):
        cosa_i_pad[f] = _cos_at(f, vpos[f])
        cosa_j_pad[f] = _cos_at(f, upos[f])
        cosa_c[f] = _cos_at(f, pos_pad[f])
        cosa_cn[f] = _cos_at(f, cpos[f])
    rsina_i = 1.0 / np.sqrt(np.maximum(1.0 - cosa_i_pad ** 2, 0.25))
    rsina_j = 1.0 / np.sqrt(np.maximum(1.0 - cosa_j_pad ** 2, 0.25))
    rsin2_c = 1.0 / np.maximum(1.0 - cosa_c ** 2, 0.25)
    rsin2_cn = 1.0 / np.maximum(1.0 - cosa_cn ** 2, 0.25)

    # --- halo wind basis correction R (see Grid docstring) ---------------
    # stored halo components are the OWNER's covariant components relabeled
    # by the fill's signed permutation; R re-expresses them as covariant
    # components in OUR extended chart at the same physical point:
    #   V = co'_x e'^x + co'_y e'^y   (owner dual basis),
    #   co_ours,i = E_i . V,   then compose with the inverse relabeling.
    r11 = np.ones((NFACES, N, N))
    r12 = np.zeros((NFACES, N, N))
    r21 = np.zeros((NFACES, N, N))
    r22 = np.ones((NFACES, N, N))
    for f in range(NFACES):
        f2 = spec.src_face_x[f]
        remote = f2 != f
        if not remote.any():
            continue
        q = pos_pad[f]                       # true point of every slot
        E1, E2 = _basis_at(f, q)             # our extended basis
        # owner basis at its own center (exact: owner cells are interior)
        b1 = np.zeros((N, N, 3))
        b2 = np.zeros((N, N, 3))
        for g in np.unique(f2[remote]):
            mg = f2 == g
            g1, g2 = _basis_at(g, q[mg])
            b1[mg], b2[mg] = g1, g2
        cosg = np.sum(b1 * b2, axis=-1, keepdims=True)
        s2 = np.maximum(1.0 - cosg ** 2, 1e-6)
        d1 = (b1 - cosg * b2) / s2           # owner dual basis e'^x
        d2 = (b2 - cosg * b1) / s2           # e'^y
        C11 = np.sum(E1 * d1, -1)
        C12 = np.sum(E1 * d2, -1)
        C21 = np.sum(E2 * d1, -1)
        C22 = np.sum(E2 * d2, -1)
        # invert the relabeling P (ours = P theirs, topology.py docstring):
        # no swap: their_x = vsx u_s, their_y = vsy v_s
        # swap:    their_x = vsy v_s, their_y = vsx u_s
        sw = spec.vswap_x[f]
        sy = spec.vsy_x[f].astype(np.float64)
        sx = spec.vsx_x[f].astype(np.float64)
        r11[f] = np.where(remote, np.where(sw, C12 * sx, C11 * sx), 1.0)
        r12[f] = np.where(remote, np.where(sw, C11 * sy, C12 * sy), 0.0)
        r21[f] = np.where(remote, np.where(sw, C22 * sx, C21 * sx), 0.0)
        r22[f] = np.where(remote, np.where(sw, C21 * sy, C22 * sy), 1.0)

    # --- halo A-grid resampling onto extended-chart gridpoints -----------
    # After the basis rotation the halo components are in our chart, but
    # they are SAMPLES AT THE NEIGHBOR'S CENTERS.  In our extended chart a
    # W/E-halo center lies exactly on the extended xi gridline but shifted
    # ALONG the edge in eta (mirror symmetry: the reflection that maps the
    # neighbor's grid onto our extension preserves xi = const great
    # circles and stretches eta by tan(pi/4 - alpha)); S/N-halo mirrors in
    # xi.  The midpoint average onto the shared edge then reads the wind
    # half a cell off along the edge - an O(h) error at ONE interface
    # column, i.e. an O(1) flux-divergence error at edge cells (measured:
    # flat 1.4e-3 Pa/s d(delp)/dt edge RMS across c12-c48).  Fix: one
    # static 3-point Lagrange resample along the off-grid coordinate,
    # identity (exact zeros) in the interior.
    xi_s = np.arctan2(np.einsum("fijk,fk->fij", pos_pad,
                                np.stack([FACE_FRAMES[f][1] for f in range(NFACES)])),
                      np.einsum("fijk,fk->fij", pos_pad,
                                np.stack([FACE_FRAMES[f][0] for f in range(NFACES)])))
    eta_s = np.arctan2(np.einsum("fijk,fk->fij", pos_pad,
                                 np.stack([FACE_FRAMES[f][2] for f in range(NFACES)])),
                       np.einsum("fijk,fk->fij", pos_pad,
                                 np.stack([FACE_FRAMES[f][0] for f in range(NFACES)])))
    c_ext, _ = _local_coords(n, h)  # extended-chart center coords, length N
    xi_g = np.broadcast_to(c_ext[None, None, :], (NFACES, N, N))
    eta_g = np.broadcast_to(c_ext[None, :, None], (NFACES, N, N))
    tol = 1e-9
    on_xi = np.abs(xi_s - xi_g) < tol
    on_eta = np.abs(eta_s - eta_g) < tol

    def _lagrange3(t, tm, t0, tp):
        """Quadratic Lagrange weights for samples at (tm, t0, tp)
        evaluated at t (denominators guarded; degenerate slots are
        discarded by the caller's `good` mask)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            wm = (t - t0) * (t - tp) / ((tm - t0) * (tm - tp))
            w0 = (t - tm) * (t - tp) / ((t0 - tm) * (t0 - tp))
            wp = (t - tm) * (t - t0) / ((tp - tm) * (tp - t0))
        return (np.nan_to_num(wm), np.nan_to_num(w0), np.nan_to_num(wp))

    jwm = np.zeros((NFACES, N, N))
    jwp = np.zeros((NFACES, N, N))
    iwm = np.zeros((NFACES, N, N))
    iwp = np.zeros((NFACES, N, N))
    # W/E halo: xi on-grid, eta shifted -> resample along j (not at the
    # outermost rows, where a centered 3-pt stencil has no neighbors)
    sel_j = on_xi & ~on_eta
    sel_j[:, 0, :] = False
    sel_j[:, -1, :] = False
    if sel_j.any():
        em = np.roll(eta_s, 1, axis=1)
        ep = np.roll(eta_s, -1, axis=1)
        wm, w0, wp = _lagrange3(eta_g, em, eta_s, ep)
        # only trust the stencil when the 3 samples are distinct and ordered
        good = sel_j & (em < eta_s - tol) & (eta_s < ep - tol)
        jwm[good], jwp[good] = wm[good], wp[good]
    # S/N halo: eta on-grid, xi shifted -> resample along i
    sel_i = on_eta & ~on_xi
    sel_i[:, :, 0] = False
    sel_i[:, :, -1] = False
    if sel_i.any():
        xm = np.roll(xi_s, 1, axis=2)
        xp = np.roll(xi_s, -1, axis=2)
        wm, w0, wp = _lagrange3(xi_g, xm, xi_s, xp)
        good = sel_i & (xm < xi_s - tol) & (xi_s < xp - tol)
        iwm[good], iwp[good] = wm[good], wp[good]

    # --- staggered-halo resampling weights (see Grid docstring) ----------
    # same construction as jwm/iwm but at the staggered sample positions
    # (upos/vpos, gathered above): u-grid ideal coords are (xi = centers,
    # eta = interfaces), v-grid the transpose
    s_ext = (np.arange(N + 1) - h) * ((np.pi / 2) / n) - np.pi / 4

    def _stag_weights(pos, xi_ideal, eta_ideal):
        A = np.stack([FACE_FRAMES[f][0] for f in range(NFACES)])
        B = np.stack([FACE_FRAMES[f][1] for f in range(NFACES)])
        Cv = np.stack([FACE_FRAMES[f][2] for f in range(NFACES)])
        xi_p = np.arctan2(np.einsum("fjik,fk->fji", pos, B),
                          np.einsum("fjik,fk->fji", pos, A))
        eta_p = np.arctan2(np.einsum("fjik,fk->fji", pos, Cv),
                           np.einsum("fjik,fk->fji", pos, A))
        R, C = xi_p.shape[1:]
        xig = np.broadcast_to(xi_ideal[None, None, :], (NFACES, R, C))
        etag = np.broadcast_to(eta_ideal[None, :, None], (NFACES, R, C))
        on_x = np.abs(xi_p - xig) < tol
        on_e = np.abs(eta_p - etag) < tol
        sjwm = np.zeros((NFACES, R, C))
        sjwp = np.zeros_like(sjwm)
        siwm = np.zeros_like(sjwm)
        siwp = np.zeros_like(sjwm)
        sel = on_x & ~on_e
        sel[:, 0] = sel[:, -1] = False
        em = np.roll(eta_p, 1, axis=1)
        ep = np.roll(eta_p, -1, axis=1)
        wm, _, wp = _lagrange3(etag, em, eta_p, ep)
        good = sel & (em < eta_p - tol) & (eta_p < ep - tol)
        sjwm[good], sjwp[good] = wm[good], wp[good]
        sel = on_e & ~on_x
        sel[:, :, 0] = sel[:, :, -1] = False
        xm = np.roll(xi_p, 1, axis=2)
        xp = np.roll(xi_p, -1, axis=2)
        wm, _, wp = _lagrange3(xig, xm, xi_p, xp)
        good = sel & (xm < xi_p - tol) & (xi_p < xp - tol)
        siwm[good], siwp[good] = wm[good], wp[good]
        return sjwm, sjwp, siwm, siwp

    su_jwm, su_jwp, su_iwm, su_iwp = _stag_weights(upos, c_ext, s_ext)
    sv_jwm, sv_jwp, sv_iwm, sv_iwp = _stag_weights(vpos, s_ext, c_ext)

    # extended-chart center-to-center spacings (identical on every face);
    # interior entries copied from dxc so in-face values stay bit-identical
    # cpts[j, i] = chart point at (xi_i, eta_j)
    cpts = face_point(0, np.broadcast_to(c_ext[None, :], (N, N)),
                      np.broadcast_to(c_ext[:, None], (N, N)))
    dxc_c = dxc.copy()
    d_in = _gc_dist(cpts[:, :-1], cpts[:, 1:]) * RADIUS  # [N, N-1]
    dxc_c[:, :, 1:N] = d_in[None, :, :]
    dyc_c = dyc.copy()
    d_in = _gc_dist(cpts[:-1, :], cpts[1:, :]) * RADIUS
    dyc_c[:, 1:N, :] = d_in[None, :, :]
    # keep the physical dxc wherever it matches (bit-identical interior)
    same = np.abs(dxc_c - dxc) < 1e-6 * cell
    dxc_c = np.where(same, dxc, dxc_c)
    same = np.abs(dyc_c - dyc) < 1e-6 * cell
    dyc_c = np.where(same, dyc, dyc_c)

    # corner Coriolis: exact everywhere from the padded corner positions
    fcor_c = 2 * OMEGA * cpos[..., 2]

    # geometry-exact corner interpolation corrections (see _corner_interp_dw)
    corner_dw = _corner_interp_dw(cpos, pos_pad)

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return Grid(
        n=n,
        h=h,
        spec=spec,
        lat=f32(lat),
        lon=f32(lon),
        area=f32(area_pad),
        rarea=f32(1.0 / area_pad),
        dx=f32(dx_pad),
        dy=f32(dy_pad),
        dxc=f32(dxc),
        dyc=f32(dyc),
        fcor=f32(fcor),
        fcor_c=f32(fcor_c),
        corner_mask=spec.corner_mask,
        corner_dw=f32(corner_dw),
        su_jwm=f32(su_jwm), su_jwp=f32(su_jwp),
        su_iwm=f32(su_iwm), su_iwp=f32(su_iwp),
        sv_jwm=f32(sv_jwm), sv_jwp=f32(sv_jwp),
        sv_iwm=f32(sv_iwm), sv_iwp=f32(sv_iwp),
        dr11=f32(r11 - 1.0),
        r12=f32(r12),
        r21=f32(r21),
        dr22=f32(r22 - 1.0),
        jwm=f32(jwm), jwp=f32(jwp),
        iwm=f32(iwm), iwp=f32(iwp),
        dxc_c=f32(dxc_c), dyc_c=f32(dyc_c),
        cosa_i=f32(cosa_i_pad),
        rsina_i=f32(rsina_i),
        cosa_j=f32(cosa_j_pad),
        rsina_j=f32(rsina_j),
        cosa_c=f32(cosa_c),
        rsin2_c=f32(rsin2_c),
        cosa_cn=f32(cosa_cn),
        rsin2_cn=f32(rsin2_cn),
    )

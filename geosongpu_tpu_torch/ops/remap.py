"""Vertical Lagrangian-to-Eulerian remap (geosongpu_tpu/ops/remap.py).

Arrays: [..., K] layer means, [..., K+1] interfaces, top -> surface.
`remap_fields_banded` is the plain PyTorch version of the CUDA kernel in
ops/kernels/remap.py (csrc/remap_banded.cu): the kernel computes exactly
this function, and the CPU path and the on-card comparison use it.
`lagrangian_to_eulerian` is the full remap step of cell-centred fields on
`remap_field`.
"""
from __future__ import annotations

import torch


def _ppm_edges_k(q: torch.Tensor, dp: torch.Tensor):
    """Monotone PPM edges along the last axis for nonuniform thicknesses
    dp: thickness-weighted 2-cell interface values clipped to the
    neighbour means, one-sided 2nd-order top and bottom edges, then the
    two-pass Colella-Woodward limiter.  Returns (aL, aR, a6)."""
    qm = q[..., :-1]
    qp = q[..., 1:]
    w = dp[..., :-1] / (dp[..., :-1] + dp[..., 1:])
    e = qm + (qp - qm) * w
    e = torch.minimum(torch.maximum(e, torch.minimum(qm, qp)),
                      torch.maximum(qm, qp))
    s_top = (q[..., 1:2] - q[..., :1]) / (0.5 * (dp[..., :1] + dp[..., 1:2]))
    top = q[..., :1] - s_top * 0.5 * dp[..., :1]
    s_bot = (q[..., -1:] - q[..., -2:-1]) / (
        0.5 * (dp[..., -1:] + dp[..., -2:-1]))
    bot = q[..., -1:] + s_bot * 0.5 * dp[..., -1:]
    edges = torch.cat([top, e, bot], dim=-1)
    aL = edges[..., :-1]
    aR = edges[..., 1:]
    extremum = (aR - q) * (q - aL) <= 0.0
    aL = torch.where(extremum, q, aL)
    aR = torch.where(extremum, q, aR)
    da = aR - aL
    a6 = 6.0 * (q - 0.5 * (aL + aR))
    aL = torch.where(a6 * da > da * da, 3.0 * q - 2.0 * aR, aL)
    da = aR - aL
    a6 = 6.0 * (q - 0.5 * (aL + aR))
    aR = torch.where(a6 * da < -da * da, 3.0 * q - 2.0 * aL, aR)
    a6 = 6.0 * (q - 0.5 * (aL + aR))
    return aL, aR, a6


def _partial_integral(aL, aR, a6, x0, x1):
    """Integral of the cell parabola over normalized [x0, x1] (fraction of
    the layer from its top interface), not divided by the width."""
    da = aR - aL

    def anti(x):
        return aL * x + 0.5 * da * x * x + a6 * (0.5 * x * x - x * x * x / 3.0)

    return anti(x1) - anti(x0)


def remap_field(q: torch.Tensor, pe1: torch.Tensor, pe2: torch.Tensor,
                kord: int = 8) -> torch.Tensor:
    """Full overlap form: every (target l, source k) pair, O(K^2) per
    column.  Conservative for any pe2 within pe1's range."""
    _check_kord(kord)
    dp1 = pe1[..., 1:] - pe1[..., :-1]
    aL, aR, a6 = _ppm_edges_k(q, dp1)
    lo = torch.maximum(pe1[..., None, :-1], pe2[..., :-1, None])
    hi = torch.minimum(pe1[..., None, 1:], pe2[..., 1:, None])
    dp1b = dp1[..., None, :]
    x0 = torch.clamp((lo - pe1[..., None, :-1]) / dp1b, 0.0, 1.0)
    x1 = torch.clamp((hi - pe1[..., None, :-1]) / dp1b, 0.0, 1.0)
    x1 = torch.maximum(x1, x0)
    contrib = _partial_integral(aL[..., None, :], aR[..., None, :],
                                a6[..., None, :], x0, x1) * dp1b
    target_mass = contrib.sum(dim=-1)
    return target_mass / (pe2[..., 1:] - pe2[..., :-1])


def _shift_k(a: torch.Tensor, d: int, fill: float) -> torch.Tensor:
    """a[..., l+d] along the last axis; out-of-range slots get `fill`."""
    if d == 0:
        return a
    pad = torch.full(a.shape[:-1] + (abs(d),), fill, dtype=a.dtype,
                     device=a.device)
    if d > 0:
        return torch.cat([a[..., d:], pad], dim=-1)
    return torch.cat([pad, a[..., :d]], dim=-1)


def _check_kord(kord: int) -> None:
    if kord != 8:
        raise NotImplementedError(f"kord={kord}: only the monotone kord 8 "
                                  "remap exists (as in the reference)")


def remap_fields_banded(qs, pe1: torch.Tensor, pe2: torch.Tensor,
                        kord: int = 8, band: int = 10):
    """Banded remap of several fields sharing (pe1, pe2): equal to
    remap_field whenever target layer l draws only from source layers
    l-band..l+band.  The overlap geometry is computed once per shift and
    applied to every field.  Returns a list, one entry per field."""
    _check_kord(kord)
    K1 = qs[0].shape[-1]
    if pe2.shape[-1] != K1 + 1:
        raise ValueError("banded remap needs as many target as source layers")
    band = min(band, K1 - 1)
    dp1 = pe1[..., 1:] - pe1[..., :-1]
    edges = [_ppm_edges_k(q, dp1) for q in qs]
    pe1_lo, pe1_hi = pe1[..., :-1], pe1[..., 1:]
    pe2_lo, pe2_hi = pe2[..., :-1], pe2[..., 1:]

    totals = [torch.zeros_like(pe2_lo) for _ in qs]
    BIG = 3e30
    for d in range(-band, band + 1):
        fill = BIG if d > 0 else -BIG
        lo_s = _shift_k(pe1_lo, d, fill)
        hi_s = _shift_k(pe1_hi, d, fill)
        dp_s = _shift_k(dp1, d, 1.0)
        rdp_s = 1.0 / dp_s
        lo = torch.maximum(lo_s, pe2_lo)
        hi = torch.minimum(hi_s, pe2_hi)
        x0 = torch.clamp((lo - lo_s) * rdp_s, 0.0, 1.0)
        x1 = torch.clamp((hi - lo_s) * rdp_s, 0.0, 1.0)
        x1 = torch.maximum(x1, x0)
        for i, (aL, aR, a6) in enumerate(edges):
            totals[i] = totals[i] + _partial_integral(
                _shift_k(aL, d, 0.0), _shift_k(aR, d, 0.0),
                _shift_k(a6, d, 0.0), x0, x1) * dp_s
    rdp2 = 1.0 / (pe2_hi - pe2_lo)
    return [t * rdp2 for t in totals]


def remap_field_banded(q: torch.Tensor, pe1: torch.Tensor, pe2: torch.Tensor,
                       kord: int = 8, band: int = 10) -> torch.Tensor:
    """Single-field form of remap_fields_banded."""
    return remap_fields_banded([q], pe1, pe2, kord, band)[0]


def lagrangian_to_eulerian(delp, pt, u_cell, v_cell, q, ak, bk, ptop,
                           kord: int = 8):
    """Full remap step on cell-centred fields [..., K] (+ tracers with a
    trailing tracer axis, or None): the target coordinate ak + bk ps from
    the surface pressure of delp, and every field remapped onto it with
    remap_field.  ak, bk: [K+1] tensors on the fields' device.

    Returns (delp_new, pt_new, u_new, v_new, q_new, ps, pe2).
    """
    from .vertical import interfaces_from_delp

    pe1 = interfaces_from_delp(delp, ptop)
    ps = pe1[..., -1]
    pe2 = ak + bk * ps[..., None]
    delp_new = pe2[..., 1:] - pe2[..., :-1]

    pt_new = remap_field(pt, pe1, pe2, kord)
    u_new = remap_field(u_cell, pe1, pe2, kord)
    v_new = remap_field(v_cell, pe1, pe2, kord)
    if q is not None:
        # tracers carry a trailing tracer axis [..., K, T]
        q_new = torch.stack([remap_field(q[..., t], pe1, pe2, kord)
                             for t in range(q.shape[-1])], dim=-1)
    else:
        q_new = None
    return delp_new, pt_new, u_new, v_new, q_new, ps, pe2

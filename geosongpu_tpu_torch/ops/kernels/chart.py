"""The cube-corner chart corrections as hand-written CUDA
(csrc/chart_corners.cu): `chart_scalar` and `chart_agrid`, the two apply
operations of core/chart_corners.py::ChartCorners, each one launch that
patches the corner squares of the caller's arrays in place.

Counterparts of no Pallas kernel: the reference applies the corrections as
XLA glue (geosongpu_tpu/core/chart_corners.py `_apply_scalar`,
`_apply_agrid`).  For each kernel: the wrapper, its `launches` counter and
its plain PyTorch version `<name>_plain`, the kernel's reference in the
tests, which sums the taps in the kernel's order and returns new tensors:
chains of fused multiply-adds (one rounding a tap, `_fma`), the scalar
taps as two chains added at the end, the A-grid taps as one, which is how
the einsum form's batched products (cuBLAS) summed them on an H100 at the
c192-L72 shapes (csrc/chart_corners.cu says why that matters).
ChartCorners routes CUDA arrays here; on the CPU it keeps its einsum
form, which patches in place too.

A wrapper given CPU tensors copies the plain version's result into the
arrays.  Given CUDA tensors it checks that every array is a contiguous
float32 tensor of the shapes the weights ask for, launches the C entry on
the current stream and raises on a CUDA error.  Either way it patches the
caller's arrays in place and returns them.  Arrays are [F, Ny, Nx, ...]
with the trailing dims flattened to K levels; F, Ny, Nx and K come from
the inputs, h from the caller (the halo width: patches of P = h + 4 cells,
squares of W = h + 2).  Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import math

import torch

from ...spans import spanned
from .build import check_tensors, device_of, launch


def _start(far: int, n: int, span: int) -> int:
    """First row (column) of a corner's span at the far or near end."""
    return n - span if far else 0


def _corners(Ny: int, Nx: int, span: int):
    """(corner, row slice, column slice) of each corner's span x span
    square, corners SW, SE, NW, NE."""
    for c in range(4):
        y0, x0 = _start(c >> 1, Ny, span), _start(c & 1, Nx, span)
        yield c, slice(y0, y0 + span), slice(x0, x0 + span)


def _fma(a, b, c):
    """a * b + c rounded once to float32, as the card's fmaf: the product
    is exact in float64, the sum's remainder exact by TwoSum, and it decides
    the one case float64's own rounding hides, a float32 tie."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    e = (p - (s - t)) + (cd - t)           # p + cd == s + e exactly
    r = s.float()
    inf = torch.full_like(r, float("inf"))
    other = torch.where(r.double() < s, torch.nextafter(r, inf),
                        torch.nextafter(r, -inf))
    tie = (r.double() + other.double()) * 0.5 == s
    toward = torch.where(other > r, e > 0, e < 0)
    return torch.where(tie & toward, other, r)


def chart_scalar_plain(a, weights, h: int):
    """The corner squares of a [F, Ny, Nx, ...] array resampled in
    deviation form with weights [F, 4, W*W, P*P] -> a new array."""
    F, Ny, Nx = a.shape[:3]
    P, W = h + 4, h + 2
    half = (P * P + 1) // 2
    x = a.reshape(F, Ny, Nx, -1)
    out = x.clone(memory_format=torch.contiguous_format)
    for (c, ys, xs), (_, qy, qx) in zip(_corners(Ny, Nx, P),
                                        _corners(Ny, Nx, W)):
        samp = x[:, ys, xs].reshape(F, P * P, -1)
        base = x[:, qy, qx].reshape(F, W * W, -1)
        wd = weights[:, c]
        chains = []
        for taps in (range(half), range(half, P * P)):
            acc = torch.zeros_like(base)
            for p in taps:
                acc = _fma(wd[:, :, p, None], samp[:, None, p] - base, acc)
            chains.append(acc)
        out[:, qy, qx] = (base + (chains[0] + chains[1])).reshape(F, W, W, -1)
    return out.reshape(a.shape)


def chart_agrid_plain(ua, va, pu, pv, weights, mask, h: int):
    """The masked corner slots of ua and va [F, Ny, Nx, ...] reconstructed
    from pu [F, Ny+1, Nx, ...] and pv [F, Ny, Nx+1, ...] with weights
    [F, 4, 2*W*W, 2*(P+1)*P] -> new (ua, va)."""
    F, Ny, Nx = ua.shape[:3]
    P, W = h + 4, h + 2
    WW = W * W
    outs = [t.reshape(F, Ny, Nx, -1).clone(
        memory_format=torch.contiguous_format) for t in (ua, va)]
    u = pu.reshape(F, Ny + 1, Nx, -1)
    v = pv.reshape(F, Ny, Nx + 1, -1)
    for c, qy, qx in _corners(Ny, Nx, W):
        y0, x0 = _start(c >> 1, Ny, P), _start(c & 1, Nx, P)
        samp = torch.cat([
            u[:, y0:y0 + P + 1, x0:x0 + P].reshape(F, (P + 1) * P, -1),
            v[:, y0:y0 + P, x0:x0 + P + 1].reshape(F, P * (P + 1), -1)],
            dim=1)
        wd = weights[:, c]
        rec = torch.zeros((F, 2 * WW, samp.shape[-1]), dtype=samp.dtype,
                          device=samp.device)
        for s in range(samp.shape[1]):
            rec = _fma(wd[:, :, s, None], samp[:, None, s], rec)
        m = mask[:, c].reshape(mask.shape[0], WW, 1)
        for comp, out in enumerate(outs):
            cur = out[:, qy, qx].reshape(F, WW, -1)
            new = torch.where(m, rec[:, comp * WW:(comp + 1) * WW], cur)
            out[:, qy, qx] = new.reshape(F, W, W, -1)
    return outs[0].reshape(ua.shape), outs[1].reshape(va.shape)


def _extents(kernel: str, a, h: int):
    """(F, Ny, Nx, K) of a [F, Ny, Nx, ...] array, whose rows and columns
    must hold a corner's patch and keep the four squares apart."""
    if a.dim() < 3:
        raise ValueError(f"{kernel}: arrays must be [F, Ny, Nx, ...], got "
                         f"shape {tuple(a.shape)}")
    F, Ny, Nx = a.shape[:3]
    if min(Ny, Nx) < max(h + 4, 2 * (h + 2)):
        raise ValueError(f"{kernel}: {Ny} x {Nx} slots are too few for the "
                         f"corners of halo {h}")
    return F, Ny, Nx, math.prod(a.shape[3:])


@spanned("kernel.chart_scalar")
def chart_scalar(a, weights, h: int):
    """Resample the corner squares of a padded [F, Ny, Nx, ...] scalar
    -> a, patched in place.  weights: [F, 4, W*W, P*P], one table of the
    chart's."""
    if device_of("chart_scalar: a", a).type == "cpu":
        return a.copy_(chart_scalar_plain(a, weights, h))
    F, Ny, Nx, K = _extents("chart_scalar", a, h)
    P, W = h + 4, h + 2
    check_tensors("chart_scalar", a.device, [
        ("a", a, a.shape), ("weights", weights, (F, 4, W * W, P * P))])
    launch("chart_scalar", "PPiiili", a.device,
           [a.data_ptr(), weights.data_ptr(), F, Ny, Nx, K, h])
    chart_scalar.launches += 1
    return a


@spanned("kernel.chart_agrid")
def chart_agrid(ua, va, pu, pv, weights, mask, h: int):
    """Overwrite the masked corner slots of the A-grid winds ua, va
    [F, Ny, Nx, ...] with the chart reconstruction from the padded D-grid
    winds pu, pv -> (ua, va), patched in place.  weights: [F, 4, 2*W*W, S];
    mask: bool [1 or F, 4, W*W]."""
    if device_of("chart_agrid: ua", ua).type == "cpu":
        gua, gva = chart_agrid_plain(ua, va, pu, pv, weights, mask, h)
        return ua.copy_(gua), va.copy_(gva)
    F, Ny, Nx, K = _extents("chart_agrid", ua, h)
    P, W = h + 4, h + 2
    trail = tuple(ua.shape[3:])
    dev = ua.device
    check_tensors("chart_agrid", dev, [
        ("ua", ua, ua.shape), ("va", va, ua.shape),
        ("pu", pu, (F, Ny + 1, Nx) + trail),
        ("pv", pv, (F, Ny, Nx + 1) + trail),
        ("weights", weights, (F, 4, 2 * W * W, 2 * (P + 1) * P))])
    if (mask.device != dev or mask.dtype != torch.bool
            or mask.shape[0] not in (1, F)
            or tuple(mask.shape[1:]) != (4, W * W)
            or not mask.is_contiguous()):
        raise ValueError(f"chart_agrid: mask must be a contiguous bool "
                         f"[1 or {F}, 4, {W * W}] tensor on {dev}, got "
                         f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
    launch("chart_agrid", "PPPPPPiiiili", dev,
           [ua.data_ptr(), va.data_ptr(), pu.data_ptr(), pv.data_ptr(),
            weights.data_ptr(), mask.data_ptr(), mask.shape[0], F, Ny, Nx,
            K, h])
    chart_agrid.launches += 1
    return ua, va


KERNELS = (chart_scalar, chart_agrid)
for _k in KERNELS:
    _k.launches = 0

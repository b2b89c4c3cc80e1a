"""Cube-corner chart corrections, apply side (geosongpu_tpu/core/chart_corners.py).

The weights are the reference's own numpy `ChartCornerTables`
(`build_chart_tables`); this module moves them to the device once and
applies them with torch.  The order of the reference is kept exactly:
each corner's patch is read from the INPUT array and its base from the
running output, one static-slice block update per corner.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from geosongpu_tpu.core.chart_corners import (ChartCornerTables,
                                              _corner_patch_slices,
                                              _patch_width)

from ..device import to_torch


@dataclass(frozen=True)
class ChartCorners:
    """Device copy of the corner weights + the two apply operations."""

    h: int
    sc_dw_x: torch.Tensor   # [6, 4, W*W, P*P]
    sc_dw_y: torch.Tensor
    sc_ex: torch.Tensor     # one-sided weights for derived fields
    st_w: torch.Tensor      # [6, 4, 2*W*W, S]
    st_mask: torch.Tensor   # [4, W*W] bool

    @classmethod
    def from_tables(cls, tables: ChartCornerTables, device) -> "ChartCorners":
        return cls(h=tables.h,
                   sc_dw_x=to_torch(tables.sc_dw_x, device),
                   sc_dw_y=to_torch(tables.sc_dw_y, device),
                   sc_ex=to_torch(tables.sc_ex, device),
                   st_w=to_torch(tables.st_w, device),
                   st_mask=torch.as_tensor(tables.st_mask, device=device))

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
            Wd = W_all[:, cid]                        # [6, WW, PP]
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
            Wd = self.st_w[:, cid]                    # [6, 2*WW, S]
            rec = torch.einsum("fws,fs...->fw...", Wd, samp)
            mshape = (1, WW) + (1,) * (rec.ndim - 2)
            mask = self.st_mask[cid].reshape(mshape)
            for comp, tgt in ((0, ua_out), (1, va_out)):
                blk = tgt[:, ysq, xsq]
                cur = blk.reshape((blk.shape[0], WW) + blk.shape[3:])
                new = torch.where(mask, rec[:, comp * WW:(comp + 1) * WW], cur)
                tgt[:, ysq, xsq] = new.reshape(blk.shape)
        return ua_out, va_out

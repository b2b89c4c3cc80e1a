"""The GFDL-1M microphysics column update as a hand-written CUDA kernel
(csrc/gfdl_microphysics.cu).

Counterpart of geosongpu_tpu/ops/pallas/microphysics.py
(gfdl_microphysics_pallas :152).  That Pallas body repeats the primary's
formulas in the primary's operation order with its own copies of the
saturation functions, and so does the CUDA kernel; the plain PyTorch
version beside it is therefore the primary itself,
physics/standalone.py::gfdl_microphysics (its result is a named tuple).

`gfdl_microphysics` is the wrapper: for CPU tensors the plain version; for
CUDA tensors it checks the seven inputs (contiguous float32 [..., K] of one
shape), flattens the leading axes to columns, launches the kernel and
raises on a CUDA error.  `gfdl_microphysics.launches` counts launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...physics import standalone as primary
from ...physics.thermo import (CP_AIR, EPS, GRAV, HLS, HLV, RDGAS, RVGAS,
                               T_ICE)
from ...spans import spanned
from .build import device_of, launch
from .columns import column_extents

_IN = ("t", "qv", "ql", "qr", "qi", "p", "delp")


def kernel_constants(dt: float):
    """The kernel's constants in the order of ConstId in the source: each
    a Python expression of the plain version, evaluated in double as Python
    does there and rounded to float32 where it meets a tensor."""
    return (T_ICE, EPS, 1.0 - EPS, HLV, RVGAS, RDGAS, GRAV, HLV / CP_AIR,
            primary.HLF / CP_AIR, HLS / CP_AIR, CP_AIR, primary.HLF,
            -dt * 1.0e-4, 1.0 - math.exp(-dt / primary.TAU_WBF),
            primary.QL_CRIT, 1.0 - math.exp(-dt / primary.TAU_AUTO),
            -dt * primary.C_ACC, primary.RHO0, primary.VT_RAIN_MAX,
            primary.VT_ICE_MAX, dt, -dt * primary.C_REVP)


# the plain version: the primary -> (t', qv', ql', qr', qi', precip)
gfdl_microphysics_plain = primary.gfdl_microphysics


@spanned("kernel.gfdl_microphysics")
def gfdl_microphysics(t, qv, ql, qr, qi, p, delp, dt: float):
    """One physics step of the microphysics on columns [..., K], top to
    surface -> (t', qv', ql', qr', qi' [..., K], precip [...])."""
    if device_of("gfdl_microphysics: t", t).type == "cpu":
        return gfdl_microphysics_plain(t, qv, ql, qr, qi, p, delp, dt)
    ins = (t, qv, ql, qr, qi, p, delp)
    dev, shape, ncol, K = column_extents("gfdl_microphysics",
                                         list(zip(_IN, ins)))
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for _ in range(5)]
    precip = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
    consts = kernel_constants(float(dt))
    c_arr = (ctypes.c_float * len(consts))(*consts)
    launch("gfdl_microphysics", "li" + "P" * 7 + "Pi" + "P" * 6, dev,
           [ncol, K, *(a.data_ptr() for a in ins),
            ctypes.addressof(c_arr), len(consts),
            *(o.data_ptr() for o in outs), precip.data_ptr()])
    gfdl_microphysics.launches += 1
    return (*outs, precip)


gfdl_microphysics.launches = 0

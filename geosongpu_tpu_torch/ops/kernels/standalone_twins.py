"""Second sources of the Buoyancy and EvapSublPdfLoop column kernels as
hand-written CUDA (csrc/standalone_twins.cu).

Counterparts of geosongpu_tpu/ops/pallas/standalone_twins.py
(buoyancy_pallas :85, evap_subl_pdf_pallas :133).  Like those they are
re-derivations of the primaries in physics/standalone.py with their own
constants and expressions, held to the primaries by the dual-build gate
(physics/standalone_gate.py, rel RMS 1e-4), not to the bit:

* buoyancy through the density ratio at equal pressure,
  B = g (T_p (1 + fac q_p) / (T_e (1 + fac q_e)) - 1), fac = Rv/Rd - 1;
* evaporation/sublimation with inlined saturation pressures, the clear
  fraction as 0.5 + (1 - rh) / (2 w), and the limiters in another order.

The plain versions here repeat the twins' arithmetic, not the primaries'.
The constants are the twins' own: `_LS` = 2.834e6 J/kg, as in the JAX
twin, where the primary's thermo.HLS is 2.836e6.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
checks them (contiguous float32 [..., K] of one shape), launches the kernel
and raises on a CUDA error.  Each has a `launches` counter.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...spans import spanned
from .build import device_of, launch
from .columns import column_extents

# own constants (not imported from physics.thermo)
_RD = 287.04
_RV = 461.50
_G = 9.80665
_CP = 1004.64
_T0 = 273.16
_LV = 2.501e6
_LS = 2.834e6


def buoyancy_plain(t, qv, p, t_parcel, qv_parcel):
    fac = _RV / _RD - 1.0
    num = t_parcel * (1.0 + fac * qv_parcel)
    den = t * (1.0 + fac * qv)
    return _G * (num / den - 1.0)


def evap_subl_pdf_plain(t, qv, ql, qi, p, dt: float, pdf_width: float = 0.1):
    """-> (t', qv', ql', qi')."""
    eps = _RD / _RV
    tc = t - _T0
    es_l = 611.2 * torch.exp(17.67 * tc / (tc + 243.5))
    es_l = torch.minimum(es_l, 0.9 * p)
    qs_l = eps * es_l / (p - (1.0 - eps) * es_l)
    es_i = 611.2 * torch.exp(21.87 * tc / (tc + 265.5))
    es_i = torch.minimum(es_i, 0.9 * p)
    qs_i = eps * es_i / (p - (1.0 - eps) * es_i)

    rh = qv / torch.clamp_min(qs_l, 1e-12)
    # clear fraction = integral of the triangular RH PDF above saturation
    clear = torch.clamp(0.5 + (1.0 - rh) / (2.0 * pdf_width), 0.0, 1.0)
    f = 1.0 - math.exp(-dt / 900.0)

    # cap by subsaturation first, then by the available condensate
    evap = torch.minimum(torch.clamp_min(qs_l - qv, 0.0), ql * clear * f)
    evap = torch.minimum(evap, ql)
    subl = torch.minimum(torch.clamp_min(qs_i - qv, 0.0), qi * clear * f)
    subl = torch.minimum(subl, qi)

    return (t - (_LV * evap + _LS * subl) / _CP, qv + evap + subl,
            ql - evap, qi - subl)


def evap_constants(dt: float, pdf_width: float):
    """The evap_subl_pdf kernel's constants, in the order its C entry
    reads them."""
    eps = _RD / _RV
    return (_T0, eps, 1.0 - eps, 2.0 * pdf_width,
            1.0 - math.exp(-dt / 900.0), _LV, _LS, _CP)


@spanned("kernel.buoyancy")
def buoyancy(t, qv, p, t_parcel, qv_parcel):
    """Parcel buoyancy [m/s^2] -> [..., K].  p is checked but not read
    (the densities are compared at equal pressure)."""
    if device_of("buoyancy: t", t).type == "cpu":
        return buoyancy_plain(t, qv, p, t_parcel, qv_parcel)
    dev, shape, ncol, K = column_extents(
        "buoyancy", [("t", t), ("qv", qv), ("p", p), ("t_parcel", t_parcel),
                     ("qv_parcel", qv_parcel)])
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    launch("buoyancy", "li" + "PPPP" + "ff" + "P", dev,
           [ncol, K, t.data_ptr(), qv.data_ptr(), t_parcel.data_ptr(),
            qv_parcel.data_ptr(), _RV / _RD - 1.0, _G, out.data_ptr()])
    buoyancy.launches += 1
    return out


@spanned("kernel.evap_subl_pdf")
def evap_subl_pdf(t, qv, ql, qi, p, dt: float, pdf_width: float = 0.1):
    """Evaporation of cloud liquid and sublimation of cloud ice into
    subsaturated air -> (t', qv', ql', qi')."""
    if device_of("evap_subl_pdf: t", t).type == "cpu":
        return evap_subl_pdf_plain(t, qv, ql, qi, p, dt, pdf_width)
    ins = (t, qv, ql, qi, p)
    dev, shape, ncol, K = column_extents(
        "evap_subl_pdf", list(zip(("t", "qv", "ql", "qi", "p"), ins)))
    outs = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for _ in range(4))
    consts = evap_constants(float(dt), float(pdf_width))
    c_arr = (ctypes.c_float * len(consts))(*consts)
    launch("evap_subl_pdf", "li" + "P" * 5 + "Pi" + "P" * 4, dev,
           [ncol, K, *(a.data_ptr() for a in ins), ctypes.addressof(c_arr),
            len(consts), *(o.data_ptr() for o in outs)])
    evap_subl_pdf.launches += 1
    return outs


KERNELS = (buoyancy, evap_subl_pdf)
for _k in KERNELS:
    _k.launches = 0

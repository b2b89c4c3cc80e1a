"""The least time a kernel call could take on the card, from the tensors
it is given: the larger of its bytes over the memory rate and its
operations over the float32 rate.

A call moves each input once and writes each output once (of the 36
PaddedMetrics arrays only those its stages read, METRICS_READ), and does
OPS_PER_POINT operations per point of its largest output.  chip_smoke.py
reckons each kernel's bound this way and the roofline script
(scripts/roofline.py) the bytes of each launch of a traced step, so the
two count the same bytes.
"""
from __future__ import annotations

import torch

from .profiler import CARD, HBM_PEAK

HBM_BYTES_PER_S = HBM_PEAK[CARD]
F32_FLOP_PER_S = 67e12   # float32 outside the tensor cores (data sheet)

# Arithmetic of the plain version per output point, each PPM edge counted
# once per cell (a ppm_flux ~33 operations with the hord-8 limiter, an
# fvtp2d ~150 per field, a corner interpolation ~15, a column integral ~60
# with pow and log as 20 each; gfdl_microphysics 13 exp, 4 pow and a sqrt at
# 20 each plus ~25 divisions and ~120 other operations; cup_gf_sh one
# theta_v with a pow and the two interfaces' mixing of two fields).  Every
# kernel comes out bound by its bytes.
OPS_PER_POINT = {
    "remap_banded": 250, "dsw_csw1": 80, "dsw_csw2": 170,
    "dsw_transport": 330, "dsw_transport nh": 650, "dsw_wind": 220,
    "dsw_wind blend": 280, "dsw_wind nh": 345, "dsw_tracer_acc": 170,
    "dsw_tracer": 165, "dsw_nh_pert": 70,
    "gfdl_microphysics": 500, "fill_q2_zero": 6, "aer_activation": 70,
    "moist_rad_coup": 35, "cup_gf_sh": 60, "buoyancy": 10,
    "evap_subl_pdf": 80,
}
# The PaddedMetrics fields each kernel (and form) reads: the met(m, X, ...)
# uses of its source and of the csrc/dsw_common.cuh stages it launches
# (fvtp2d, hydro_columns).  The bound counts these metric arrays and no
# other.  dsw_wind's rotational damping (VTX_METRICS)
# is off in every preset and in the timed calls.
FVTP2D_METRICS = ("area", "dx", "dy", "rdxc", "rdyc")
WIND_METRICS = ("phis", "dw00", "dw01", "dw10", "dw11", "rsin2_cn",
                "cosa_cn", "dx", "dy", "rdx", "rdy", "rdxc", "rdyc")
VTX_METRICS = ("fcor", "dxc", "dyc")
COLUMN_KERNELS = ("gfdl_microphysics", "fill_q2_zero", "aer_activation",
                  "moist_rad_coup", "cup_gf_sh", "buoyancy",
                  "evap_subl_pdf")
METRICS_READ = {
    "remap_banded": (),
    "dsw_csw1": ("cosa_i", "rsina_i", "cosa_j", "rsina_j", "rdxc", "rdyc",
                 "dx", "dy", "rarea", "rsin2_c", "cosa_c", "fcor"),
    "dsw_csw2": ("phis", "jwm", "jwp", "iwm", "iwp", "rdxc_c", "rdyc_c"),
    "dsw_transport": FVTP2D_METRICS + ("rarea",),
    "dsw_transport nh": FVTP2D_METRICS + ("rarea",),
    "dsw_wind": WIND_METRICS,
    "dsw_wind blend": WIND_METRICS + (
        "div_blend", "rarea", "rarea_c", "cosa_i", "rsina_i", "cosa_j",
        "rsina_j", "dxc", "dyc"),
    "dsw_wind nh": WIND_METRICS,
    "dsw_tracer_acc": FVTP2D_METRICS + ("rarea",),
    "dsw_tracer": FVTP2D_METRICS + ("rarea",),
    "dsw_nh_pert": (),
    **{k: () for k in COLUMN_KERNELS},
}


def tensors_of(args, metric_names):
    """The input tensors of a kernel call: its array arguments and, of a
    PaddedMetrics argument, the fields in `metric_names` (each input
    counted once, also where two arguments are one array)."""
    seen, out = set(), []
    for a in args:
        if hasattr(a, "_fields"):
            a = tuple(getattr(a, n) for n in metric_names)
        for t in (a if isinstance(a, tuple) else (a,)):
            if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                out.append(t)
    return out


def moved_bytes(tensors_in, tensors_out) -> int:
    """Bytes of one call: every input read and every output written once."""
    return sum(t.numel() * t.element_size()
               for t in list(tensors_in) + list(tensors_out))


def bound(name, tensors_in, tensors_out, points=None):
    """(ms by bytes, ms by operations) of one call: its inputs read and its
    outputs written once against the card's memory rate, and
    OPS_PER_POINT[name] operations per point (default: the points of its
    largest output) against its float32 rate.  The bound is the larger."""
    if points is None:
        points = max(t.numel() for t in tensors_out)
    return (moved_bytes(tensors_in, tensors_out) / HBM_BYTES_PER_S * 1e3,
            OPS_PER_POINT[name] * points / F32_FLOP_PER_S * 1e3)

"""The bytes and operations of the aquaplanet physics chain's three column
kernels in one model step, counted from the configuration alone.

Frozen copy of the reckoning of geosongpu_tpu_torch/benchmark/bounds.py
(OPS_PER_POINT of the column kernels) at commit 3eef9d40c49f, counted as
portbench/counts.py counts the dycore's calls: a call reads each of its
inputs once and writes each of its outputs once, and does OPS_PER_POINT
operations per point of its largest output.  The calls are those of one
physics chain of geosongpu_tpu_torch/models/aquaplanet.py on the fused
path (pallas_microphysics): one fill of the three tracers, one shallow
convection and one microphysics call.  The plain PyTorch between them
(the Exner function, the surface fluxes, the relaxation) is glue and is
not counted.

Each call is an object with `wrapper`, `bytes` and `ops`, which is all
that portbench/counts.py `bound_s` and the readers read.
"""
from __future__ import annotations

from typing import NamedTuple

OPS_PER_POINT = {"fill_q2_zero": 6, "cup_gf_sh": 60, "gfdl_microphysics": 500}
F32 = 4  # bytes
TRACERS = 3  # qv, ql, qr


class ColumnCall(NamedTuple):
    wrapper: str   # the program's kernel wrapper (its `kernel.*` span)
    bytes: int
    ops: int


def _call(wrapper: str, ins: int, outs: int, points: int) -> ColumnCall:
    """ins, outs: float32 values read and written."""
    return ColumnCall(wrapper, (ins + outs) * F32,
                      OPS_PER_POINT[wrapper] * points)


def step_calls(cfg: dict) -> list:
    """The column kernels' calls of one step of the DycoreConfig fields
    `cfg`, each with its bytes and operations."""
    if not cfg["pallas_microphysics"]:
        raise ValueError("the count is of the kernel path "
                         "(pallas_microphysics)")
    n, K = cfg["npx"], cfg["npz"]
    cols = 6 * n * n
    c = cols * K
    return [
        # the tracer array's first three tracers and delp -> three tracers
        _call("fill_q2_zero", TRACERS * c + c, TRACERS * c, TRACERS * c),
        # t, qv, p_mid, delp -> t, qv
        _call("cup_gf_sh", 4 * c, 2 * c, c),
        # t, qv, ql, qr, qi, p_mid, delp -> t, qv, ql, qr, qi; precip
        _call("gfdl_microphysics", 7 * c, 5 * c + cols, c),
    ]


# the __global__ kernel of each wrapper, as a device trace names it
KERNELS = {"fill_q2_zero_columns": "fill_q2_zero",
           "cup_gf_sh_points": "cup_gf_sh",
           "gfdl_microphysics_columns": "gfdl_microphysics"}


def kernel_of(name: str):
    """The wrapper whose kernel a device event's name
    ("(anonymous namespace)::cup_gf_sh_points(long long, ...)") is, or
    None."""
    for kernel, wrapper in KERNELS.items():
        if name.startswith(kernel + "(") or f"::{kernel}(" in name:
            return wrapper
    return None


def device_us(events) -> dict:
    """{wrapper: device us} of the column kernels' launches among the
    device events `events` (portbench/devtrace.py)."""
    out = {}
    for e in events:
        w = kernel_of(e.name) if e.cat == "kernel" else None
        if w is not None:
            out[w] = out.get(w, 0.0) + e.dur
    return out

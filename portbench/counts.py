"""The bytes and operations of one model step, counted from the
configuration alone.

Frozen copy of the reckoning of geosongpu_tpu_torch/benchmark/bounds.py
(OPS_PER_POINT, METRICS_READ, the metric fields' staggers of
ops/kernels/dsw.py METRIC_STAGGER, the peaks of benchmark/profiler.py) at
commit f902e7ad95fb: a call reads each of its inputs once and writes each
of its outputs once, of the 36 padded metric arrays only those its stages
read, and does OPS_PER_POINT operations per point of its largest output
(the remap: per point of all its outputs).

The calls are those of today's fused step, derived from the shapes and
the launch counts the configuration implies, not recorded from the
program: n_split x (dsw_csw1, dsw_csw2, dsw_transport, dsw_wind; with the
nonhydrostatic step also dsw_nh_pert, nh_vertical_solve and dsw_tracer per
tracer), q_split x dsw_tracer_acc per tracer (z_tracer), and the three
remap calls.  So the count reads the same work whatever later implements
it.  Under chart corners a y-fill is the x-fill itself and counts once.
The glue between the kernels is not counted: the step's count is a lower
bound on its traffic.  portbench/tests/test_counts.py holds these counts
equal to the program's own recorder at small shapes.
"""
from __future__ import annotations

from typing import NamedTuple

# the card's data-sheet peaks (SXM, dense, at its 700 W limit), by the name
# torch.cuda.get_device_name gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flop_per_s": 67e12},
}

OPS_PER_POINT = {
    "remap_banded": 250, "dsw_csw1": 80, "dsw_csw2": 170,
    "dsw_transport": 330, "dsw_transport nh": 650, "dsw_wind": 220,
    "dsw_wind blend": 280, "dsw_wind nh": 345, "dsw_tracer_acc": 170,
    "dsw_tracer": 165, "dsw_nh_pert": 70, "nh_vertical_solve": 180,
}

FVTP2D_METRICS = ("area", "dx", "dy", "rdxc", "rdyc")
WIND_METRICS = ("phis", "dw00", "dw01", "dw10", "dw11", "rsin2_cn",
                "cosa_cn", "dx", "dy", "rdx", "rdy", "rdxc", "rdyc")
VTX_METRICS = ("fcor", "dxc", "dyc")
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
    "nh_vertical_solve": (),
}

# (rows - Ny, cols - Nx) of each metric field, [F, rows, cols, 1]
METRIC_STAGGER = {
    "area": (0, 0), "rarea": (0, 0), "dx": (1, 0), "dy": (0, 1),
    "dxc": (0, 1), "dyc": (1, 0), "fcor": (0, 0), "rarea_c": (1, 1),
    "cosa_i": (0, 1), "rsina_i": (0, 1), "cosa_j": (1, 0),
    "rsina_j": (1, 0), "rdx": (1, 0), "rdy": (0, 1), "rdxc": (0, 1),
    "rdyc": (1, 0), "cosa_c": (0, 0), "rsin2_c": (0, 0), "cosa_cn": (1, 1),
    "rsin2_cn": (1, 1), "phis": (0, 0), "dw00": (1, 1), "dw01": (1, 1),
    "dw10": (1, 1), "dw11": (1, 1), "dr11": (0, 0), "r12": (0, 0),
    "r21": (0, 0), "dr22": (0, 0), "jwm": (0, 0), "jwp": (0, 0),
    "iwm": (0, 0), "iwp": (0, 0), "rdxc_c": (0, 1), "rdyc_c": (1, 0),
    "div_blend": (1, 1),
}

F32 = 4  # bytes


class Call(NamedTuple):
    wrapper: str   # the program's kernel wrapper
    form: str      # its key in OPS_PER_POINT and METRICS_READ
    bytes: int
    points: int

    @property
    def ops(self) -> int:
        return OPS_PER_POINT[self.form] * self.points


def _blend(cfg: dict) -> bool:
    return cfg["damping_exchange"] == "blend" or (
        cfg["damping_exchange"] == "auto" and cfg["npx"] > 96)


def step_calls(cfg: dict) -> list:
    """The kernel calls of one fused model step of the DycoreConfig fields
    `cfg`, each with its bytes and points."""
    if not cfg["pallas_dycore"]:
        raise ValueError("the count is of the fused step (pallas_dycore)")
    F, n, h, K = 6, cfg["npx"], cfg["halo"], cfg["npz"]
    Ny = Nx = n + 2 * h
    c, xi, yi, cn = (F * Ny * Nx * K, F * Ny * (Nx + 1) * K,
                     F * (Ny + 1) * Nx * K, F * (Ny + 1) * (Nx + 1) * K)
    # a y-fill is a second array only without chart corners
    y = 0 if cfg["chart_corners"] else 1
    nh = not cfg["hydrostatic"]
    T = cfg["ntracers"]
    z_tracer = cfg["z_tracer"] and T > 0
    substep_tracers = T > 0 and not z_tracer

    def metric_bytes(form):
        names = set(METRICS_READ[form])
        if form.startswith("dsw_wind") and cfg["vtx_damp"] > 0.0:
            names |= set(VTX_METRICS)
        return sum(F * (Ny + METRIC_STAGGER[k][0])
                   * (Nx + METRIC_STAGGER[k][1]) for k in names) * F32

    def call(wrapper, form, ins, outs, points=None):
        return Call(wrapper, form,
                    (sum(ins) + sum(outs)) * F32 + metric_bytes(form),
                    max(outs) if points is None else points)

    substep = [
        # pu, pv, ua, va, pd_x(, pd_y), pt_x(, pt_y)
        call("dsw_csw1", "dsw_csw1", [yi, xi] + [c] * (4 + 2 * y),
             [xi, yi] + [c] * 4),
        # uc, vc, delp_h, pt_h, ke, vort
        call("dsw_csw2", "dsw_csw2", [xi, yi] + [c] * 4, [xi, yi]),
    ]
    if nh:
        # pd, pt, pw, pz fills, uct, vct
        substep.append(call("dsw_transport", "dsw_transport nh",
                            [c] * (4 + 4 * y) + [xi, yi],
                            [c, c, xi, yi, c, c]))
    else:
        substep.append(call("dsw_transport", "dsw_transport",
                            [c] * (2 + 2 * y) + [xi, yi], [c, c, xi, yi]))
    if substep_tracers:
        # qx(, qy), pd_x, delp_new, uct, mfx, vct, mfy
        substep += [call("dsw_tracer", "dsw_tracer",
                         [c] * (3 + y) + [xi, xi, yi, yi], [c])] * T
    if nh:
        substep += [
            call("nh_vertical_solve", "nh_vertical_solve", [c] * 4, [c, c]),
            call("dsw_nh_pert", "dsw_nh_pert", [c] * 3, [c] * 3),
            # pu, pv, uct, vct, delp_f, pt_f, vort, delz_f (, div_c)
            call("dsw_wind", "dsw_wind nh",
                 [yi, xi, xi, yi] + [c] * 4 + ([] if _blend(cfg) else [cn]),
                 [yi, xi]),
        ]
    elif _blend(cfg):
        substep.append(call("dsw_wind", "dsw_wind blend",
                            [yi, xi, xi, yi] + [c] * 3, [yi, xi]))
    else:
        substep.append(call("dsw_wind", "dsw_wind",
                            [yi, xi, xi, yi, cn] + [c] * 3, [yi, xi]))
    calls = substep * cfg["n_split"]
    if z_tracer:
        # qx(, qy), pd_x, uacc, mfx, vacc, mfy
        calls += [call("dsw_tracer_acc", "dsw_tracer_acc",
                       [c] * (2 + y) + [xi, xi, yi, yi], [c, c])] * (
                           cfg["q_split"] * T)
    # the remap: pt, the tracers (, w, delz) on (pe1, pe2); u; v
    C, U, V = F * n * n * K, F * (n + 1) * n * K, F * n * (n + 1) * K
    pe, peu, pev = (F * n * n * (K + 1), F * (n + 1) * n * (K + 1),
                    F * n * (n + 1) * (K + 1))
    nf = 1 + T + (2 if nh else 0)
    calls += [call("remap_banded", "remap_banded", [C] * nf + [pe, pe],
                   [C] * nf, points=nf * C),
              call("remap_banded", "remap_banded", [U, peu, peu], [U],
                   points=U),
              call("remap_banded", "remap_banded", [V, pev, pev], [V],
                   points=V)]
    return calls * cfg["k_split"]


def bound_s(calls, peaks) -> float:
    """The least time of `calls` together: the larger of their bytes over
    the memory rate and their operations over the float32 rate."""
    return max(sum(k.bytes for k in calls) / peaks["hbm_bytes_per_s"],
               sum(k.ops for k in calls) / peaks["f32_flop_per_s"])


def calls_bound_s(calls, peaks) -> float:
    """The sum of each call's own least time (a kernel's roofline)."""
    return sum(bound_s([k], peaks) for k in calls)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, and exits non-zero
on any failure (and when no CUDA device is present).

    python3 chip_smoke.py --stages

runs phases 1 and 2 and then only the per-stage view of the fvtp2d
callers, dsw_csw1 and dsw_nh_pert (STAGE_KERNELS), of remap_banded at
the three calls of a c48-L72 and a c192-L72 step, and of the column
kernels on the gate's sounding at 128 x 40, 13,824 x 32 and 221,184 x 72
(COLUMN_STAGES): gfdl_microphysics, the fill of three tracers (three
single-field fills of contiguous copies, as the model called them before
the multi-tracer form, and that form where the tree has it) and the five
pointwise kernels (POINTWISE).  Each against its plain version, which it
must equal (0.0; remap_banded and the pointwise kernels outside EXACT
within REL_GATE, so that the view runs on an older tree too), its median
time and, from a torch.profiler window of 10 calls, the device time of
each __global__ stage it launches and of all the call's device work; a
pointwise kernel also with its bound and the device time's share of it.
Run it from copies of two trees in one call to compare their kernels;
`--stages columns` runs the column view alone.
Without arguments, the phases:

1. device: the card's name and power limit (nvidia-smi), the toolchain;
2. build: the one kernel library from the checkout's csrc/ sources, with
   ptxas registers and spills per kernel;
3. remap_banded against its plain PyTorch version at the three c48-L72
   main-path shapes (max error relative to the plain output <= 1e-5), with
   6 fields, more than one launch takes (two launches), and at the three
   calls of a c192-L72 step, each with its bound and the share of it;
4. the substep kernels against their plain versions, over the whole padded
   outputs, on inputs from a real state (init + 2 steps, then the substep
   chain of plain versions): the five hydrostatic kernels at c48-L72; the
   nonhydrostatic forms (dsw_transport with w and delz, dsw_tracer,
   dsw_nh_pert, dsw_wind with the p', phi', rho terms) at c48-L72 on a
   nonhydrostatic state; at c192-L72, where the card and not the host
   sets the time, the five kernels the c192 preset launches (dsw_wind in
   its blend form); dsw_csw2 and dsw_wind on the JW06 preset's inputs
   (perturbed init + 2 steps, its balancing terrain in the metrics), where
   each must equal its plain version (0.0).
   dsw_csw1, dsw_transport, dsw_tracer and dsw_tracer_acc within 1e-5 of
   max|plain|; dsw_csw2, dsw_wind and dsw_nh_pert within max(1e-4
   max|plain|, 2e-3), for the column-sum order;
5. the seven column-physics kernels (gfdl_microphysics, fill_q2_zero,
   aer_activation, moist_rad_coup, cup_gf_sh, buoyancy, evap_subl_pdf)
   against their plain versions, within 1e-5 of max|plain|, and
   gfdl_microphysics, fill_q2_zero, cup_gf_sh and aer_activation (EXACT)
   equal to them in every element: on the five datasets of the physics
   gate (128 x 40, seeds 1000-1004), at a ragged column count (123 x 16),
   and at the aquaplanet
   model's 13,824 x 32 - gfdl_microphysics and fill_q2_zero there on the
   inputs the physics chain hands them after 2 steps from a moist-perturbed
   state (cloud and rain present; the fill in its multi-tracer form on the
   state's tracer array, the row the kernels line reports, and in its
   single-field form on each tracer), the five others on the gate's
   sounding at that shape; all seven, and the fill in both forms, also at
   13,824 x 72 and 221,184 x 72, the column counts of c48-L72 and
   c192-L72;
6. the dual-build gate of the physics kernels as a path of its own, with
   the counts set to 0 before and read after: each primary against its
   hand kernel over the five datasets, relative RMS <= 1e-4 per variable,
   every kernel launched exactly five times;
7. the seven presets through build_model / init / step, each with every
   launch count set to 0 just before and read just after: the rest state
   stays at rest (nonhydrostatic: w and p' at rounding level; not for the
   JW06 preset, whose unperturbed state is a balanced flow), the steps
   stay finite, mass is conserved, and every kernel launches exactly as
   often as the path prescribes (per step, PATHS below); the aquaplanet
   presets also pass the aquaplanet task's physical gates (vapour in
   [-1e-6, 0.06], surface pressure in (5e4, 1.2e5) Pa) and moisten;
8. a torch.profiler window of 2 steps of each preset: device busy time,
   device events per step and the top device kernels;
9. card against CPU: 3 steps at c12-L8 from one numpy state, the two c48
   hydrostatic presets, the nonhydrostatic preset and the blend form; the
   fused aquaplanet preset at c8-L12 from a moist-perturbed state (ql and
   qr relative to max|qv|); and the JW06 preset at c12-L26 with its
   terrain, whose gate also admits twice the CPU's own spread under one ulp
   of pt (NOISE_FACTOR);
10. the one-day steady gate of tests/test_baroclinic_wave.py at c24-L26
   (the reference's eager configuration: max|ps - 1e5| < 1,200 Pa, max|u|
   < 40 m/s), then the JW06 validation (JW_EXPERIMENT: c48-L26, 4 steady
   and 10 wave days of 144 steps) through the port's harness dispatch,
   with every launch count set to 0 just before and read just after
   (exact over the 2,016 steps), the task's four gates (steady max|ps - 1e5| <= 1,500 Pa, day-4
   ps_min >= 98,600 Pa, day-9 ps_min in [90,000, 99,000] Pa, the deepest
   low at 20-80 N), its results printed beside the reference's calibration;
11. the CI pipelines through the port's dispatch, each in a temporary
   directory, with the tasks' own checks: the Benchmark action of
   held_suarez_c48 (c48-L32, 24 steps) and aquaplanet_c48 (c48-L32, 16
   steps), every count set to 0 just before each dispatch and read just
   after: each member's record carries its own launches (its steps and
   its phase tree), which must equal exactly what its configuration
   gives (run_launches: the fused member every kernel of its path - for
   the aquaplanet also dsw_tracer_acc, fill_q2_zero, cup_gf_sh and
   gfdl_microphysics - the eager member only remap_banded), a step's
   share equal to its preset's in PATHS, and the members' launches add up
   to the dispatch's; each record's median ms/step, gridpoints/s and top
   five phase-tree leaves printed with the card line, and the fused
   member's speed-up over the eager one; the Validation of
   held_suarez_c192 (eager c192-L72, 8 steps) on the one card under the
   same launch rule, its mesh description printed; the Validation of
   hs_climatology_smoke (eager c12-L16, 720 steps from the committed
   spun-up state) on the card, its HS94 gates, remap_banded three times a
   step; and physics_standalone_all, each of the seven column kernels
   launched exactly once a dataset.

Phases 3 to 5 print the median time of 20 calls (10 at c192), kernel and
plain.  The second-to-last line is the kernels JSON object, the last line
{"ok": true, "device": {...}}; the c192-L72 rows of the other four substep
kernels and of remap_banded go on a line of their own before those,
{"kernels_c192": [...]}, with the same keys.  `launches` in the kernels
object is the count of the fused Held-Suarez path (c192 and
nonhydrostatic for those forms), of the fused aquaplanet path for
gfdl_microphysics, fill_q2_zero and cup_gf_sh, of the gate path for
the four kernels only the gate runs, and of the JW06 path for the rows
`dsw_csw2 jw` and `dsw_wind jw` (the terrain form).

Each kernel's bound in that object is the larger of two times computed
here from the call's shapes: every input read and every output written
once at 3.35 TB/s (of the 36 PaddedMetrics arrays only those the kernel's
stages read, METRICS_READ), and OPS_PER_POINT operations per output point
at the card's 67 TFLOP/s of float32 outside the tensor cores; a column
kernel counts only the arrays its formula reads (aer_activation takes t and
p and moist_rad_coup and buoyancy take p without reading them).  No single
PyTorch call computes any of these stencil and column functions - the
column physics are chains of tens of elementwise operations with a
recurrence down the column - so library_ms is null throughout.
"""
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time

REL_GATE = 1e-5          # kernel vs plain, relative to max |plain|
COLUMN_GATE = 1e-4       # column-integrating kernels: relative, with a floor
COLUMN_WIND_ATOL = 2e-3  # m/s (dsw_nh_pert: Pa, m2/s2, kg/m3)
SLICE_GATE = 1e-4        # card vs CPU after 3 steps (whole-slice gate)
SLICE_WIND_ATOL = 6e-3   # m/s
# JW06 card vs CPU: at c12-L26 the trajectory's own float32 noise exceeds
# the wind floor (one ulp of pt in half the cells moves u by ~5e-3 m/s in
# 3 steps on the CPU), so the gate there also admits NOISE_FACTOR times
# that spread, measured in the same run
NOISE_FACTOR = 2.0
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# kernel -> (source, the TPU kernel it replaces, column-integral gate?)
KERNELS = {
    "remap_banded": ("remap_banded.cu",
                     "geosongpu_tpu/ops/pallas/remap.py:28", False),
    "dsw_csw1": ("dsw_csw1.cu", "geosongpu_tpu/dycore/sw_pallas.py:482",
                 False),
    "dsw_csw2": ("dsw_csw2.cu", "geosongpu_tpu/dycore/sw_pallas.py:510",
                 True),
    "dsw_transport": ("dsw_transport.cu",
                      "geosongpu_tpu/dycore/sw_pallas.py:553", False),
    "dsw_wind": ("dsw_wind.cu", "geosongpu_tpu/dycore/sw_pallas.py:641",
                 True),
    "dsw_tracer_acc": ("dsw_tracer_acc.cu",
                       "geosongpu_tpu/dycore/sw_pallas.py:377", False),
    "dsw_tracer": ("dsw_tracer.cu", "geosongpu_tpu/dycore/sw_pallas.py:586",
                   False),
    "dsw_nh_pert": ("dsw_nh_pert.cu", "geosongpu_tpu/dycore/sw_pallas.py:82",
                    True),
    "gfdl_microphysics": ("gfdl_microphysics.cu",
                          "geosongpu_tpu/ops/pallas/microphysics.py:152",
                          False),
    "fill_q2_zero": ("fill_q2_zero.cu",
                     "geosongpu_tpu/ops/pallas/columns.py:99", False),
    "aer_activation": ("column_kernels.cu",
                       "geosongpu_tpu/ops/pallas/columns.py:30", False),
    "moist_rad_coup": ("column_kernels.cu",
                       "geosongpu_tpu/ops/pallas/columns.py:30", False),
    "cup_gf_sh": ("column_kernels.cu",
                  "geosongpu_tpu/ops/pallas/columns.py:30", False),
    "buoyancy": ("standalone_twins.cu",
                 "geosongpu_tpu/ops/pallas/standalone_twins.py:85", False),
    "evap_subl_pdf": ("standalone_twins.cu",
                      "geosongpu_tpu/ops/pallas/standalone_twins.py:133",
                      False),
}
COLUMN_PHYSICS = list(KERNELS)[8:]
# the column kernels that must equal their plain versions in every element
# (the other three keep REL_GATE)
EXACT = ("gfdl_microphysics", "fill_q2_zero", "cup_gf_sh", "aer_activation")
# the pointwise column kernels, in the order --stages columns takes them
POINTWISE = ("cup_gf_sh", "aer_activation", "evap_subl_pdf", "buoyancy",
             "moist_rad_coup")
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
    **{k: () for k in COLUMN_PHYSICS},
}
# __global__ stages of csrc/*.cu, as the profiler names them
PORT_STAGES = ("::csw1(", "::csw2_winds(", "::fvtp2d_tile<",
               "::transport_update(", "::nh_transport_update(",
               "::tracer_update(", "::tracer_sub_update(", "::wind_update<",
               "::blend_divergence(", "::hydro_columns(", "::nh_columns(",
               "::remap_banded_kernel<", "::gfdl_microphysics_columns(",
               "::fill_q2_zero_columns(", "::aer_activation_points(",
               "::moist_rad_coup_points(", "::cup_gf_sh_points(",
               "::buoyancy_points(", "::evap_subl_pdf_points(")
# --stages: preset -> (form, kernels, steps before the inputs are taken)
STAGE_KERNELS = {
    "held_suarez_c48_l72": ("c48", ["dsw_csw1", "dsw_transport",
                                    "dsw_tracer_acc"], 2),
    "held_suarez_c48_l72_nh_fused": ("nh", ["dsw_transport", "dsw_tracer",
                                            "dsw_nh_pert"], 2),
    "held_suarez_c192_l72_fused": ("c192", ["dsw_csw1", "dsw_transport",
                                            "dsw_tracer_acc"], 1),
}
# --stages also takes remap_banded at the step's three calls of these
# presets' widths (within REL_GATE: the view can run on an older tree)
REMAP_STAGES = {48: "held_suarez_c48_l72", 192: "held_suarez_c192_l72_fused"}
# --stages also takes the column kernels at these (columns, K): the
# physics gate's, the aquaplanet model's and c192-L72's column count
COLUMN_STAGES = ((128, 40), (6 * 48 * 48, 32), (6 * 192 * 192, 72))
# arguments a wrapper takes and checks but whose values no term reads
UNREAD = {"aer_activation": (2, 3), "moist_rad_coup": (2,),
          "buoyancy": (2,)}
# beside the blend dsw_wind: also checked and timed at c192-L72
C192_KERNELS = ["dsw_csw1", "dsw_csw2", "dsw_transport", "dsw_tracer_acc"]
GATE_SHAPE, RAGGED_SHAPE = (128, 40), (123, 16)
AQUA_COLUMNS = 6 * 48 * 48           # 13,824; c192: 221,184
# preset -> (label, steps timed after 3 warm-up steps, launches per step)
PATHS = {
    "held_suarez_c48_l72": ("eager", 5, {"remap_banded": 3}),
    "held_suarez_c48_l72_fused": ("fused", 10, {
        "dsw_csw1": 6, "dsw_csw2": 6, "dsw_transport": 6, "dsw_wind": 6,
        "dsw_tracer_acc": 2, "remap_banded": 3}),
    "held_suarez_c192_l72_fused": ("c192", 5, {       # n_split 8
        "dsw_csw1": 8, "dsw_csw2": 8, "dsw_transport": 8, "dsw_wind": 8,
        "dsw_tracer_acc": 2, "remap_banded": 3}),
    "held_suarez_c48_l72_nh_fused": ("nh", 5, {
        "dsw_csw1": 6, "dsw_csw2": 6, "dsw_transport": 6, "dsw_wind": 6,
        "dsw_tracer": 6, "dsw_nh_pert": 6, "remap_banded": 3}),
    # c48-L32, three tracers: dsw_tracer_acc 3 tracers x q_split 2; the
    # remap takes pt and the three tracers in one call, then u, then v;
    # the physics fills qv, ql and qr in one launch, mixes by cup_gf_sh and
    # runs the microphysics once
    "aquaplanet_c48_l32": ("aqua-eager", 10, {"remap_banded": 3}),
    "aquaplanet_c48_l32_fused": ("aqua", 10, {
        "dsw_csw1": 6, "dsw_csw2": 6, "dsw_transport": 6, "dsw_wind": 6,
        "dsw_tracer_acc": 6, "remap_banded": 3, "fill_q2_zero": 1,
        "cup_gf_sh": 1, "gfdl_microphysics": 1}),
    # c48-L26 with terrain, no tracers: the remap takes pt alone, then u,
    # then v
    "jw_baroclinic_c48_l26_fused": ("jw", 10, {
        "dsw_csw1": 6, "dsw_csw2": 6, "dsw_transport": 6, "dsw_wind": 6,
        "remap_banded": 3}),
}
# phase 10: the JW06 validation through the port's dispatch, and the
# reference's own calibration at c48-L26 (tests/test_baroclinic_wave.py:
# steady 4-day max |ps - 1e5| and ps_min by day), printed beside it
JW_EXPERIMENT = "jw_baroclinic_c48_fused"
JW_PRESET = "jw_baroclinic_c48_l26_fused"
JW_REFERENCE = {"steady": 310.0, "ps_min": {4: 99689.0, 6: 99321.0,
                                            9: 96768.0, 10: 94900.0}}
# phase 11, the CI pipelines through the port's dispatch: Benchmark
# experiment -> (the task's env key, the presets in PATHS whose per-step
# launches its eager and its fused member share: the same splits, tracers
# and kernels at another depth)
CI_BENCHMARKS = {
    "held_suarez_c48": ("hs", "held_suarez_c48_l72", "held_suarez_c48_l72_fused"),
    "aquaplanet_c48": ("aq", "aquaplanet_c48_l32", "aquaplanet_c48_l32_fused"),
}
CI_VALIDATION = "held_suarez_c192"   # eager c192-L72 on the one card
CI_STANDALONE = "physics_standalone_all"
CI_CLIMATOLOGY = "hs_climatology_smoke"   # eager c12-L16, 4 + 6 days


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def displaced_coordinates(torch, lead, K, band, gen, device):
    """(pe1, pe2) for a kernel check at the main path's depth: pe1 with
    layer thicknesses in [0.5, 1.5] x 1000 Pa; pe2 the interfaces at the
    fractional source index k + a sin(pi k / K), |a| < band/2 layers per
    column - a smooth Lagrangian displacement within the band that keeps
    every target layer at least half as thick as its source (a sorted
    random displacement makes near-empty layers, whose f32 remap is
    ill-conditioned in the plain version and the kernel alike)."""
    f64 = torch.float64
    dp = (torch.rand(lead + (K,), generator=gen, device=device,
                     dtype=f64) + 0.5) * 1000.0
    pe1 = torch.cat([torch.zeros(lead + (1,), device=device, dtype=f64),
                     torch.cumsum(dp, -1)], -1) + 100.0
    amp = (torch.rand(lead + (1,), generator=gen, device=device, dtype=f64)
           * 2.0 - 1.0) * (0.45 * band)
    k = torch.arange(K + 1, device=device, dtype=f64)
    x = k + amp * torch.sin(torch.pi * k / K)
    idx = torch.clamp(torch.floor(x).long(), 0, K - 1)
    pe2 = torch.gather(pe1, -1, idx) + (x - idx) * torch.gather(dp, -1, idx)
    pe2[..., 0], pe2[..., -1] = pe1[..., 0], pe1[..., -1]
    return pe1.float().contiguous(), pe2.float().contiguous()


def bound(name, tensors_in, tensors_out, points=None):
    """(ms by bytes, ms by operations) of one call: its inputs read and its
    outputs written once against the card's memory rate, and
    OPS_PER_POINT[name] operations per point (default: the points of its
    largest output) against its float32 rate.  The bound is the larger."""
    moved = sum(t.numel() * t.element_size()
                for t in list(tensors_in) + list(tensors_out))
    if points is None:
        points = max(t.numel() for t in tensors_out)
    return (moved / HBM_BYTES_PER_S * 1e3,
            OPS_PER_POINT[name] * points / F32_FLOP_PER_S * 1e3)


def tensors_of(torch, args, metric_names):
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


def median_ms(torch, fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def print_build_log(log: str) -> None:
    """ptxas registers and spills per kernel entry."""
    name, spills = "?", ""
    for line in log.splitlines():
        if line.startswith("== "):
            print(f"[build] {line[3:]}")
        elif "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            print(f"[build]   {name}: {regs}; {spills}")


def compare(name, got, want, column_gate):
    """Max abs and relative error over whole outputs; fails on non-finite
    values or an error above the kernel's gate.  Returns (abs, rel)."""
    worst_abs = worst_rel = 0.0
    for n, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            fail(f"{name} output {n}: shape {tuple(g.shape)} vs plain "
                 f"{tuple(w.shape)}")
        if not (bool(g.isfinite().all()) and bool(w.isfinite().all())):
            fail(f"{name} output {n}: non-finite values")
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        limit = (max(COLUMN_GATE * scale, COLUMN_WIND_ATOL) if column_gate
                 else REL_GATE * scale)
        if not err <= limit:
            fail(f"{name} output {n} {tuple(g.shape)}: error {err:.3e} > "
                 f"{limit:.3e} (max|plain| {scale:.3e})")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale if scale else 0.0)
    return worst_abs, worst_rel


def kernel_inputs(torch, np, model, dev, steps=2):
    """{kernel name: args} at the model's shapes from a real state: init
    (3 K of pt noise, a tracer 1 + 0.2 U[0,1); JW06: the perturbed
    state), `steps` steps, fill, then
    one substep of plain versions in the model's own mode (damping form,
    nonhydrostatic fields, per-substep tracers); in z_tracer mode
    dsw_tracer_acc takes the substep's winds and mass fluxes accumulated
    over n_split substeps and split in q_split subcycles."""
    from geosongpu_tpu_torch.dycore.fv_dynamics import _use_exchange
    from geosongpu_tpu_torch.dycore.sw import fill_substep
    from geosongpu_tpu_torch.dycore.sw_fused import substep_kernel_args

    cfg, ctx = model.config, model.ctx
    st = model.init(perturb=3.0)
    rng = np.random.default_rng(5)
    st.q = torch.as_tensor((1.0 + 0.2 * rng.random(tuple(st.q.shape)))
                           .astype(np.float32), device=dev)
    st = model.run(st, steps)
    dt = cfg.dt / (cfg.k_split * cfg.n_split)
    nonhydro = not cfg.hydrostatic
    s = fill_substep(ctx.ops, st.u, st.v, st.delp, st.pt,
                     None if cfg.z_tracer else st.q,
                     w=st.w if nonhydro else None,
                     delz=st.delz if nonhydro else None, chart=ctx.chart)
    args, out = substep_kernel_args(
        s, ctx.metrics, ctx.ops, dt, cfg.ptop, hord=cfg.hord,
        d2_bg=cfg.d2_bg, advect_tracers=not cfg.z_tracer,
        hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm, chart=ctx.chart,
        stag_tabs=ctx.stag if _use_exchange(cfg) else None,
        vtx_damp=cfg.vtx_damp)
    if cfg.z_tracer and cfg.ntracers:
        qx = ctx.chart.apply_scalar(ctx.ops.fill(st.q[..., 0], "x"), "x")
        r = cfg.n_split / cfg.q_split
        args["dsw_tracer_acc"] = (qx, qx, s.pd_x, out.uct_pad * r,
                                  out.vct_pad * r, out.mfx_pad * r,
                                  out.mfy_pad * r, ctx.metrics, dt, cfg.hord)
    return args


def check_kernels(torch, dsw, args, names, form, card, results, reps=20):
    """Each named kernel against its plain version on `args`, with the
    error, the median times and the bound; results[name + form] =
    (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    for kname in names:
        a = args[kname]
        kern, plain = getattr(dsw, kname), getattr(dsw, kname + "_plain")
        got, want = kern(*a), plain(*a)
        torch.cuda.synchronize()
        key = f"{kname} {form}".strip()
        err, rel = compare(key, got, want, KERNELS[kname][2])
        k_ms = median_ms(torch, lambda: kern(*a), reps=reps)
        p_ms = median_ms(torch, lambda: plain(*a), reps=reps)
        by = bound(key if key in OPS_PER_POINT else kname,
                   tensors_of(torch, a, METRICS_READ.get(
                       key, METRICS_READ[kname])), got)
        b_ms, b_by = max(by), ("bytes" if by[0] >= by[1] else "operations")
        results[key] = (err, k_ms, p_ms, b_ms, b_by)
        print(f"[kernel] {key} {tuple(got[0].shape)}: max abs err "
              f"{err:.3e}, max rel err {rel:.3e}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} (median of "
              f"{reps}; {card})")


def device_times(prof):
    """{device kernel name: (device us, launches)} of a torch.profiler
    window."""
    from torch.autograd import DeviceType

    stats = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = stats.get(e.name, (0.0, 0))
            stats[e.name] = (t + e.device_time_total, c + 1)
    return stats


def stage_view(torch, label, kern, plain, card, exact, reps=20,
               bound_of=None):
    """--stages: one kernel call against its plain version (0.0 with
    `exact`, else within REL_GATE), its median time over `reps` calls, and
    the device time per launch of each __global__ it runs and of all its
    device work per call in a profiler window of 10 calls; with
    `bound_of(outputs) -> (ms by bytes, ms by operations)`, also the bound
    and the share of it that the device time reaches."""
    from torch.profiler import ProfilerActivity, profile

    got, want = outputs_of(kern()), outputs_of(plain())
    torch.cuda.synchronize()
    if exact:
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if err != 0.0:
            fail(f"{label}: {err:.3e} from its plain version")
    else:
        err, _ = compare(label, got, want, False)
    ms = median_ms(torch, kern, reps=reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            kern()
        torch.cuda.synchronize()
    times = device_times(prof)
    stages = {n.split("::")[1].split("(")[0]: tc
              for n, tc in times.items()
              if any(s in n for s in PORT_STAGES)}
    total = sum(t for t, _ in times.values()) / 10 / 1e3
    share = ""
    if bound_of is not None:
        by = bound_of(outputs_of(got))
        share = (f"; bound {max(by):.4f} ms by "
                 f"{'bytes' if by[0] >= by[1] else 'operations'}, device at "
                 f"{100 * max(by) / total:.1f}% of it")
    print(f"[stages] {label}: max abs err {err:.3e}; {ms:.4f} ms (median of "
          f"{reps}); device ms per launch: "
          + ", ".join(f"{k} {t / c / 1e3:.4f} x{c // 10}"
                      for k, (t, c) in stages.items())
          + f"; all device work {total:.4f} ms per call{share} ({card})")


def stage_times(torch, dsw, args, names, form, card, reps=20):
    """--stages of the substep kernels `names` on `args` (0.0 each)."""
    for name in names:
        a = args[name]
        stage_view(torch, f"{name} {form} {tuple(a[0].shape)}",
                   lambda: getattr(dsw, name)(*a),
                   lambda: getattr(dsw, name + "_plain")(*a), card, True,
                   reps)


def column_stages(torch, gate, kcol, kmic, dev, card):
    """--stages of the column kernels on the gate's sounding at
    COLUMN_STAGES: gfdl_microphysics and the fill of three tracers (0.0
    each), the fill as the model called it before its multi-tracer form (a
    contiguous copy of each tracer slice, one launch each) and, where the
    tree has it, that form (one launch); then the POINTWISE kernels (0.0
    for those in EXACT, else within REL_GATE), each with its bound over
    the arrays its formula reads."""
    tracers = getattr(kcol, "fill_q2_zero_tracers", None)
    for ncol, K in COLUMN_STAGES:
        d = {k: torch.as_tensor(v, device=dev)
             for k, v in gate.datasets(1000, (ncol, K)).items()}
        a = gate.arguments("GFDLMicrophysics", d)
        reps = 20 if ncol <= AQUA_COLUMNS else 10
        stage_view(torch, f"gfdl_microphysics {(ncol, K)}",
                   lambda: kmic.gfdl_microphysics(*a),
                   lambda: kmic.gfdl_microphysics_plain(*a), card, True,
                   reps)
        q, dp = three_tracers(torch, d), d["delp"]
        stage_view(torch, f"fill_q2_zero, 3 tracer copies + 3 launches "
                   f"{tuple(q.shape)}",
                   lambda: [kcol.fill_q2_zero(q[..., n].contiguous(), dp)
                            for n in range(3)],
                   lambda: [kcol.fill_q2_zero_plain(q[..., n], dp)
                            for n in range(3)], card, True, reps)
        if tracers is not None:
            stage_view(torch, f"fill_q2_zero_tracers, 1 launch "
                       f"{tuple(q.shape)}", lambda: tracers(q, dp, 3),
                       lambda: kcol.fill_q2_zero_tracers_plain(q, dp, 3),
                       card, True, reps)
        by_wrapper = {gate.WRAPPERS[g].__name__: g for g in gate.KERNELS}
        for name in POINTWISE:
            kern, plain, args, reads = column_case(gate, by_wrapper[name], d)
            stage_view(torch, f"{name} {(ncol, K)}",
                       lambda: kern(*args), lambda: plain(*args), card,
                       name in EXACT, reps,
                       lambda out: bound(name, tensors_of(torch, reads, ()),
                                         out))
        del d, a, q, dp, args, reads
        torch.cuda.empty_cache()


def remap_calls(torch, preset, npx, gen, dev):
    """The three remap calls of a step of `preset` at c`npx`, on a smooth
    Lagrangian displacement (displaced_coordinates): pt and the tracer,
    then the D-grid winds u and v on their staggered columns.  Yields
    (label, qs, pe1, pe2)."""
    K, band = preset.npz, preset.remap_band
    for label, lead, nf, scale in (("pt+q", (6, npx, npx), 2, 300.0),
                                   ("u", (6, npx + 1, npx), 1, 10.0),
                                   ("v", (6, npx, npx + 1), 1, 10.0)):
        pe1, pe2 = displaced_coordinates(torch, lead, K, band, gen, dev)
        qs = [(scale * (1.0 + 0.1 * torch.randn(lead + (K,), generator=gen,
                                                device=dev))).contiguous()
              for _ in range(nf)]
        yield label, qs, pe1, pe2


def check_remap(torch, kremap, plain, preset, npx, gen, dev, card, reps):
    """Phase 3 at c`npx`: each of a step's three remap calls against the
    plain version, with its error, median times and bound; returns the
    step's (max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    kord, band = preset.kord, preset.remap_band
    max_abs_err, kernel_ms, plain_ms, by = 0.0, 0.0, 0.0, [0.0, 0.0]
    for label, qs, pe1, pe2 in remap_calls(torch, preset, npx, gen, dev):
        got = kremap.remap_banded(qs, pe1, pe2, kord, band)
        want = plain(qs, pe1, pe2, kord, band)
        torch.cuda.synchronize()
        err, rel = compare(f"remap_banded c{npx} {label}", got, want, False)
        max_abs_err = max(max_abs_err, err)
        k_ms = median_ms(torch, lambda: kremap.remap_banded(
            qs, pe1, pe2, kord, band), reps=reps)
        p_ms = median_ms(torch, lambda: plain(qs, pe1, pe2, kord, band),
                         reps=reps)
        b = bound("remap_banded", qs + [pe1, pe2], got,
                  points=sum(t.numel() for t in got))
        kernel_ms += k_ms
        plain_ms += p_ms
        by = [x + y for x, y in zip(by, b)]
        print(f"[kernel] remap_banded c{npx} {label} {len(qs)}x"
              f"{tuple(qs[0].shape)}: max abs err {err:.3e}, max rel err "
              f"{rel:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{max(b):.4f} ms, {100 * max(b) / k_ms:.1f}% of it (median of "
              f"{reps}; {card})")
        del got, want, qs, pe1, pe2
    print(f"[kernel] remap_banded c{npx}, one step's 3 calls: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(by):.4f} "
          f"ms, {100 * max(by) / kernel_ms:.1f}% of it ({card})")
    torch.cuda.empty_cache()
    return (max_abs_err, kernel_ms, plain_ms, max(by),
            "bytes" if by[0] >= by[1] else "operations")


def column_case(gate, name, d):
    """(wrapper, plain version, arguments, the tensors its formula reads)
    of the physics gate's kernel `name` on one dataset `d` of the gate's
    recipe, with the gate's arguments (parcel t + 0.5 K, dt 600 s)."""
    kern = gate.WRAPPERS[name]
    plain = getattr(sys.modules[kern.__module__], kern.__name__ + "_plain")
    args = gate.arguments(name, d)
    reads = tuple(a for n, a in enumerate(args)
                  if n not in UNREAD.get(kern.__name__, ()))
    return kern, plain, args, reads


def outputs_of(out):
    """A wrapper's result as a list of tensors."""
    if isinstance(out, dict):
        return list(out.values())
    return list(out) if isinstance(out, (tuple, list)) else [out]


def check_column_kernel(torch, name, case, label, card, errors, results=None,
                        reps=20, counter=None, points=None):
    """One column kernel against its plain version on `case`, within
    REL_GATE of max|plain| per output, and equal to it in every element for
    the EXACT kernels; errors[name] keeps the largest absolute error seen.
    The call must count one launch on `counter` (default: the wrapper of
    `case`).  With `results`, also the median times and the bound over
    `points` (default: bound's): results[name] = (max_abs_err, ms,
    plain_ms, bound_ms, by)."""
    kern, plain, args, reads = case
    counter = counter or kern
    before = counter.launches
    got, want = outputs_of(kern(*args)), outputs_of(plain(*args))
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        fail(f"{name} {label}: the wrapper counted "
             f"{counter.launches - before} launches for one call")
    err, rel = compare(f"{name} {label}", got, want, False)
    if name in EXACT and err != 0.0:
        fail(f"{name} {label}: {err:.3e} from its plain version, not 0.0")
    errors[name] = max(errors.get(name, 0.0), err)
    shape = tuple(got[0].shape)
    if results is None:
        return err, rel
    k_ms = median_ms(torch, lambda: kern(*args), reps=reps)
    p_ms = median_ms(torch, lambda: plain(*args), reps=reps)
    by = bound(name, tensors_of(torch, reads, ()), got, points)
    b_ms, b_by = max(by), ("bytes" if by[0] >= by[1] else "operations")
    results[name] = (errors[name], k_ms, p_ms, b_ms, b_by)
    print(f"[kernel] {name} {label} {shape}: max abs err {err:.3e}, max rel "
          f"err {rel:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by} (median of {reps}; {card})")
    return err, rel


def moist_perturbation(np, q_shape):
    """Seeded factors for a moist start state: vapour x [1, 1.9) (up to
    1.14 of saturation over the initial 60%), cloud liquid up to 3e-4 and
    rain up to 1e-4 kg/kg, so that condensation, autoconversion,
    sedimentation and evaporation all act."""
    rng = np.random.default_rng(5)
    lead = tuple(q_shape[:-1])
    return ((1.0 + 0.9 * rng.random(lead)).astype(np.float32),
            (3e-4 * rng.random(lead)).astype(np.float32),
            (1e-4 * rng.random(lead)).astype(np.float32))


def moisten(torch, np, state):
    """`state` with moist_perturbation applied to its tracers."""
    fac, ql, qr = (torch.as_tensor(a, device=state.q.device)
                   for a in moist_perturbation(np, tuple(state.q.shape)))
    q = state.q.clone()
    q[..., 0] *= fac
    q[..., 1] = ql
    q[..., 2] = qr
    return dataclasses.replace(state, q=q)


def three_tracers(torch, d):
    """A tracer array [..., K, 3] laid out as the model state's, each
    tracer with negative values, from a dataset of the gate."""
    return torch.stack([d["q_neg"], d["ql"] - 2e-4, d["qr"] - 1e-4], dim=-1)


def check_column_physics(torch, np, gate, model, dev, card, results):
    """Phase 5: the seven column-physics kernels against their plain
    versions at the gate's shape, a ragged one and the model's."""
    from geosongpu_tpu_torch.ops.kernels import columns as kcol

    errors = {}

    def dataset(seed, shape):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in gate.datasets(seed, shape).items()}

    def cases(d):
        return {gate.WRAPPERS[name].__name__: column_case(gate, name, d)
                for name in gate.KERNELS}

    def check_fill_tracers(q, delp, label, results, reps=20):
        """The multi-tracer form of the fill, which counts on fill_q2_zero,
        with its bound over its three outputs."""
        check_column_kernel(
            torch, "fill_q2_zero", (kcol.fill_q2_zero_tracers,
                                    kcol.fill_q2_zero_tracers_plain,
                                    (q, delp, 3), (q, delp)),
            label, card, errors, results, reps, counter=kcol.fill_q2_zero,
            points=3 * delp.numel())

    for label, seeds, shape in (("gate", range(1000, 1005), GATE_SHAPE),
                                ("ragged", (7,), RAGGED_SHAPE)):
        worst = {}
        for seed in seeds:
            for name, case in cases(dataset(seed, shape)).items():
                _, rel = check_column_kernel(torch, name, case,
                                             f"{label} seed {seed}", card,
                                             errors)
                worst[name] = max(worst.get(name, 0.0), rel)
        print(f"[kernel] column physics at {shape} ({label}, "
              f"{len(list(seeds))} datasets), max rel err: "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    # the model's shape: microphysics and fill on what the physics chain
    # hands them, the five others on the gate's sounding
    st = model.dynamics(model.run(moisten(torch, np, model.init(perturb=3.0)),
                                  2))
    _, mp_args = model.microphysics_inputs(st)
    delp = st.delp.contiguous()
    tracers = [st.q[..., n].contiguous() for n in range(3)]
    cloudy = int((mp_args[2] > 0).sum()), int((mp_args[3] > 0).sum())
    negative = [int((q < 0).sum()) for q in tracers]
    print(f"[kernel] aquaplanet state after 2 steps + dynamics "
          f"{tuple(delp.shape)}: points with cloud {cloudy[0]}, with rain "
          f"{cloudy[1]}; negative qv/ql/qr before filling {negative}")
    if not (cloudy[0] and cloudy[1] and sum(negative)):
        fail("the aquaplanet check state has no cloud, no rain or no "
             "undershoot: the kernels would be checked on trivial inputs")
    at_model = cases(dataset(1000, (AQUA_COLUMNS, delp.shape[-1])))
    at_model["gfdl_microphysics"] = at_model["gfdl_microphysics"][:2] + (
        mp_args, mp_args[:7])
    # the fill: the single-field form on each tracer, then the multi-tracer
    # form on the state's tracer array, as the step calls it
    fill = at_model.pop("fill_q2_zero")[:2]
    for n in range(3):
        check_column_kernel(torch, "fill_q2_zero",
                            fill + ((tracers[n], delp), ()),
                            f"tracer {n}", card, errors)
    check_fill_tracers(st.q, delp, "model shape, the state's 3 tracers",
                       results)
    for name, case in at_model.items():
        check_column_kernel(torch, name, case, "model shape", card, errors,
                            results)

    # the c48-L72 and c192-L72 column counts, where a kernel's design and
    # not its launch sets its time
    for ncol in (AQUA_COLUMNS, 16 * AQUA_COLUMNS):
        d = dataset(1000, (ncol, 72))
        for name, case in cases(d).items():
            check_column_kernel(torch, name, case, "sounding", card, errors,
                                results={}, reps=10)
        check_fill_tracers(three_tracers(torch, d), d["delp"],
                           "sounding, 3 tracers", {}, reps=10)
        del d
        torch.cuda.empty_cache()
    for name in results:
        if name in errors:
            results[name] = (errors[name],) + results[name][1:]


def run_gate_path(torch, gate, counters, dev, card):
    """Phase 6: the dual-build gate as a path: counts set to 0, the gate
    of all seven kernels over its datasets, counts read.  Returns
    {kernel: launches}."""
    for fn in counters.values():
        fn.launches = 0
    worst = {}
    for name in gate.KERNELS:
        try:
            worst[name] = gate.run_gate(name, dev)
        except gate.GateMiss as e:
            fail(f"physics gate: {e}")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, got in launches.items():
        want = gate.N_DATASETS if k in COLUMN_PHYSICS else 0
        if got != want:
            fail(f"physics gate: {k} launched {got} times, expected {want}")
    print(f"[gate] primaries against hand kernels, {gate.N_DATASETS} "
          f"datasets of {gate.SHAPE}, worst rel RMS (gate {gate.REL_TOL}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f"; every kernel launched {gate.N_DATASETS} times ({card})")
    return launches


def run_preset(torch, np, model, counters, label, card, steps, per_step):
    """Rest state (not for JW06, whose unperturbed state is a balanced
    flow), then 3 + `steps` steps with every count set to 0 just before and
    read just after, finiteness, peak memory, mass drift.  Returns
    (ms/step, {kernel: launches})."""
    from geosongpu_tpu_torch.core.state import state_to_numpy

    cfg = model.config
    if label != "jw":
        check_rest_state(model, label)
    s = model.init(perturb=1e-3)
    moist = hasattr(model, "physics")
    qv0 = float(s.q[..., 0].mean()) if moist else 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    for _ in range(3):
        s = model.step(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        s = model.step(s)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / steps
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n = 3 + steps
    for k, got in launches.items():
        if got != per_step.get(k, 0) * n:
            fail(f"{label}: {k} launched {got} times in {n} steps, "
                 f"expected {per_step.get(k, 0) * n}")
    bad = [k for k, a in state_to_numpy(s).items() if not np.isfinite(a).all()]
    if bad:
        fail(f"{label}: non-finite fields after {n} steps: {bad}")
    print(f"[{label}] c{cfg.npx}-L{cfg.npz}: {sec * 1e3:.2f} ms/step, "
          f"{cfg.grid_points / sec:.4e} gridpoints/s ({steps} steps after 3 "
          f"warm-up; {card}); peak memory {peak / 2**20:.0f} MiB; launches "
          f"in {n} steps: "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; ps {float(s.ps.min()):.1f}..{float(s.ps.max()):.1f} Pa")
    if moist:
        # the aquaplanet task's physical gates, and surface evaporation
        # moistening the atmosphere
        qv = s.q[..., 0]
        lo, hi, mean = float(qv.min()), float(qv.max()), float(qv.mean())
        print(f"[{label}] qv {lo:.3e}..{hi:.3e} kg/kg, mean {qv0:.6e} -> "
              f"{mean:.6e} in {n} steps; max ql "
              f"{float(s.q[..., 1].max()):.3e}, max qr "
              f"{float(s.q[..., 2].max()):.3e}")
        if not (lo >= -1e-6 and hi <= 0.06):
            fail(f"{label}: vapour outside [-1e-6, 0.06]: {lo}..{hi}")
        if not (float(s.ps.min()) > 5.0e4 and float(s.ps.max()) < 1.2e5):
            fail(f"{label}: surface pressure outside (5e4, 1.2e5) Pa")
        if not mean > qv0:
            fail(f"{label}: mean vapour did not rise ({qv0} -> {mean})")

    s = model.init(perturb=0.5)
    w = np.asarray(model.grid.area)[model.grid.interior][..., None]
    m0 = float((w * s.delp.double().cpu().numpy()).sum())
    for _ in range(5):
        s = model.dynamics(s)
    m1 = float((w * s.delp.double().cpu().numpy()).sum())
    drift = abs(m1 - m0) / m0
    print(f"[{label}] mass drift over 5 dynamics steps: {drift:.3e}")
    if not drift < 1e-5:
        fail(f"{label}: mass drift {drift:.3e} >= 1e-5")
    return sec * 1e3, launches


def check_rest_state(model, label):
    """One dynamics step of the rest state stays at rest (nonhydrostatic:
    in balance to rounding)."""
    from geosongpu_tpu_torch.dycore.sw import nh_perturbation_fields

    cfg = model.config
    s = model.dynamics(model.init(perturb=0.0))
    umax = max(float(s.u.abs().max()), float(s.v.abs().max()))
    ps_dev = float((s.ps / 1.0e5 - 1.0).abs().max())
    print(f"[{label}] rest state after one dynamics step: max|u,v| {umax}, "
          f"max|ps/1e5 - 1| {ps_dev:.3e}")
    if umax != 0.0 or not ps_dev <= 1e-6:
        fail(f"{label}: rest state did not stay at rest")
    if not cfg.hydrostatic:
        # discrete balance holds to rounding: |w| below the reference's
        # 5e-3 m/s, p' below 1e-5 of the surface pressure
        wmax = float(s.w.abs().max())
        pp = float(nh_perturbation_fields(s.delp, s.pt, s.delz,
                                          cfg.ptop)[0].abs().max())
        print(f"[{label}] rest state: max|w| {wmax:.3e} m/s, max|p'| "
              f"{pp:.3e} Pa")
        if not (wmax < 5e-3 and pp < 1.0):
            fail(f"{label}: rest state left balance (w {wmax}, p' {pp})")


def card_vs_cpu(torch, np, pname, dev, label, size=(12, 8, 2),
                noise_floor=False, **changes):
    """3 steps of preset `pname` at size = (npx, npz, n_split), dt 1200,
    from one numpy state on the card and on the CPU, within the
    whole-slice gate; an aquaplanet preset starts from a moist-perturbed
    state and holds each tracer relative to max|qv|.  noise_floor: the gate
    also admits NOISE_FACTOR times the CPU's own spread, the 3 steps from
    the start state with pt one ulp up in a seeded half of the cells."""
    from geosongpu_tpu_torch.cli import MODELS, PRESETS, build_model_for
    from geosongpu_tpu_torch.core.state import state_from_numpy, state_to_numpy

    npx, npz, n_split = size
    small = dataclasses.replace(PRESETS[pname], npx=npx, npz=npz, dt=1200.0,
                                n_split=n_split, **changes)
    m_cpu = build_model_for(pname)(small, torch.device("cpu"))
    m_gpu = build_model_for(pname)(small, dev)
    moist = MODELS.get(pname) == "aquaplanet"
    start = state_to_numpy(m_cpu.init(perturb=3.0))
    if moist:
        fac, ql, qr = moist_perturbation(np, start["q"].shape)
        start["q"][..., 0] *= fac
        start["q"][..., 1], start["q"][..., 2] = ql, qr
    else:
        rng = np.random.default_rng(5)
        start["q"] = (1.0 + 0.2 * rng.random(start["q"].shape)
                      ).astype(np.float32)
    a = state_to_numpy(m_cpu.run(state_from_numpy(start, "cpu"), 3))
    b = state_to_numpy(m_gpu.run(state_from_numpy(start, dev), 3))
    spread = {}
    if noise_floor:
        pt = start["pt"].copy()
        up = np.random.default_rng(0).random(pt.shape) < 0.5
        pt[up] = np.nextafter(pt[up], np.float32(np.inf))
        c = state_to_numpy(m_cpu.run(state_from_numpy({**start, "pt": pt},
                                                      "cpu"), 3))
        spread = {f: float(np.abs(a[f] - c[f]).max())
                  for f in a if a[f].size}
    diffs = {}
    fields = ("u", "v", "delp", "pt", "ps") + (("q",) if small.ntracers
                                              else ())
    if not small.hydrostatic:
        fields += ("w", "delz")
    where = f"{label} card vs CPU at c{npx}-L{npz}"
    for f in fields:
        if a[f].shape != b[f].shape or not np.isfinite(b[f]).all():
            fail(f"{where}: {f} has shape {b[f].shape} on the card, "
                 f"{a[f].shape} on the CPU, or is not finite")
        # the tracers of the moist model one by one, each against max|qv|
        parts = {f: (a[f], b[f])} if not (moist and f == "q") else {
            name: (a[f][..., n], b[f][..., n])
            for n, name in enumerate(("qv", "ql", "qr"))}
        scale = float(np.abs(a[f][..., 0] if moist and f == "q"
                             else a[f]).max())
        atol = SLICE_WIND_ATOL if f in ("u", "v", "w") else 0.0
        for name, (x, y) in parts.items():
            d = float(np.abs(x - y).max())
            diffs[name] = d / scale
            limit = max(SLICE_GATE * scale, atol,
                        NOISE_FACTOR * spread.get(f, 0.0))
            if not d <= limit:
                fail(f"{where}: {name} differs by {d:.3e} > {limit:.3e} "
                     f"(scale {scale:.3e})")
    if moist and not (b["q"][..., 1].max() > 1e-4
                      and b["q"][..., 2].max() > 1e-5):
        fail(f"{where}: no cloud or no rain after 3 steps")
    print(f"[cpu-vs-card] {label} c{npx}-L{npz}, 3 steps, max rel diff"
          + (" (ql, qr relative to max|qv|): " if moist else ": ")
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
          + ("; the CPU's own max abs spread under one ulp of pt: "
             + ", ".join(f"{f} {spread[f]:.2e}" for f in fields)
             if spread else ""))


def profile_steps(torch, model, label, card, steps=2):
    """Device time, device events and the top ops over `steps` steps, after
    one profiled step that absorbs the profiler's own start-up."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    s = model.run(model.init(perturb=1e-3), 3)
    with profile(activities=acts):
        s = model.step(s)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(steps):
            s = model.step(s)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    stats = device_times(prof)
    n_events = sum(c for _, c in stats.values())
    busy = sum(t for t, _ in stats.values()) / steps / 1e3
    ours = [(t, c) for n, (t, c) in stats.items()
            if any(s in n for s in PORT_STAGES)]
    print(f"[profile] {label}: wall {wall:.2f} ms/step under the profiler, "
          f"device busy {busy:.2f} ms/step, {n_events / steps:.0f} "
          f"device events/step; the port's kernels "
          f"{sum(t for t, _ in ours) / steps / 1e3:.2f} ms/step in "
          f"{sum(c for _, c in ours) / steps:.0f} launches/step ({card})")
    stages = {}  # instantiations of a template stage add up
    for n, (t, c) in stats.items():
        for stage in PORT_STAGES:
            if stage in n:
                t0, c0 = stages.get(stage[2:-1], (0.0, 0))
                stages[stage[2:-1]] = (t0 + t, c0 + c)
    print(f"[profile] {label}: the port's stages, ms/step (launches/step): "
          + ", ".join(f"{k} {t / steps / 1e3:.3f} ({c / steps:.0f})"
                      for k, (t, c) in sorted(stages.items(),
                                              key=lambda kv: -kv[1][0])))
    top = sorted(stats.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        print(f"[profile]   {t / steps / 1e3:8.3f} ms/step {c / steps:7.0f}"
              f"/step  {name[:90]}")


def check_jw_steady_day(torch, dev, card):
    """The one-day steady gate of tests/test_baroclinic_wave.py (the
    reference's configuration: c24-L26, dt 900, n_split 6, the eager
    substep) on the card: 96 steps of the unperturbed JW06 state keep
    max|ps - 1e5| < 1,200 Pa and max|u| < 40 m/s."""
    from geosongpu_tpu_torch.core.config import DycoreConfig
    from geosongpu_tpu_torch.models.baroclinic_wave import build_model

    m = build_model(DycoreConfig(npx=24, npz=26, dt=900.0, n_split=6,
                                 ntracers=0), dev)
    t0 = time.perf_counter()
    s = m.run(m.init(perturb=False), 96)
    dev_pa = float((s.ps - 1.0e5).abs().max())
    umax = float(s.u.abs().max())
    print(f"[jw] one steady day at c24-L26 (eager): max|ps - 1e5| "
          f"{dev_pa:.1f} Pa, max|u| {umax:.2f} m/s in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    if not (dev_pa < 1200.0 and umax < 40.0):
        fail(f"JW06 steady day at c24: ps drift {dev_pa} Pa, max|u| {umax}")


def run_jw_validation(torch, counters, card):
    """The last phase: dispatch(JW_EXPERIMENT, "Validation") in a temporary
    directory, every count set to 0 just before and read just after; each
    kernel launched exactly its PATHS count per step over the steady and the
    wave days; the task's check must pass.  Prints the results beside the
    reference's calibration."""
    import tempfile

    from geosongpu_tpu_torch.harness.exceptions import CICheckException
    from geosongpu_tpu_torch.harness.task import dispatch, get_config

    raw = get_config(JW_EXPERIMENT)
    dyc = raw["experiment"]["dycore"]
    steps = (raw["steady_days"] + raw["wave_days"]) * int(
        round(86400.0 / dyc["dt"]))
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        try:
            env = dispatch(JW_EXPERIMENT, "Validation", artifact_directory=td,
                           workspace=td, device="cuda")
        except CICheckException as e:
            fail(f"{JW_EXPERIMENT}: the task's check failed: {e}")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    per_step = PATHS[JW_PRESET][2]
    for k, got in launches.items():
        if got != per_step.get(k, 0) * steps:
            fail(f"{JW_EXPERIMENT}: {k} launched {got} times in {steps} "
                 f"steps, expected {per_step.get(k, 0) * steps}")
    mins = env.get("jw.ps_min_by_day")
    ref = JW_REFERENCE["ps_min"]
    print(f"[jw] {JW_EXPERIMENT} Validation through dispatch: {steps} steps "
          f"of c{dyc['npx']}-L{dyc['npz']} in {sec:.1f} s "
          f"({sec / steps * 1e3:.2f} ms/step with the model's set-up; "
          f"{card}); steady "
          f"{raw['steady_days']} d max|ps - 1e5| "
          f"{env.get('jw.steady_ps_dev'):.1f} Pa (reference "
          f"{JW_REFERENCE['steady']:.0f}); deepest low at lat "
          f"{env.get('jw.low_lat'):.1f}; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    print("[jw] ps_min by day, Pa (reference's calibration at c48-L26 in "
          "brackets): " + ", ".join(
              f"d{d} {m:.1f}" + (f" ({ref[d]:.0f})" if d in ref else "")
              for d, m in enumerate(mins, 1)))


def run_launches(dyc, steps, warmup, tree):
    """The exact launches of one run of the HeldSuarez task (the Aquaplanet
    task's too) of a hydrostatic model under `dyc`.  A step: the banded
    remap's three calls a remap interval; under pallas_dycore each of the
    four substep kernels once a substep and dsw_tracer_acc once a tracer
    and tracer subcycle a remap interval; under pallas_microphysics the
    three physics kernels once.  The run: max(1, warmup) + steps steps and,
    with a tree, its leaves, each called TREE_CALLS times: the step leaf a
    step, the substep leaf one launch of each substep kernel, the tracer
    and the remap leaf a remap interval's, the forcing leaf the physics."""
    from geosongpu_tpu_torch.benchmark.phases import REPS
    from geosongpu_tpu_torch.harness.tasks.held_suarez import PHASE_INNER

    if not dyc.hydrostatic:
        fail("run_launches counts hydrostatic runs only")
    per_step, per_leaf = {}, {}
    if dyc.remap_band > 0:
        per_step["remap_banded"] = 3 * dyc.k_split
        per_leaf["remap_banded"] = 3
    if dyc.pallas_dycore:
        for k in ("dsw_csw1", "dsw_csw2", "dsw_transport", "dsw_wind"):
            per_step[k] = dyc.k_split * dyc.n_split
            per_leaf[k] = 1
        if dyc.z_tracer and dyc.ntracers:
            per_leaf["dsw_tracer_acc"] = dyc.ntracers * dyc.q_split
            per_step["dsw_tracer_acc"] = dyc.k_split * per_leaf[
                "dsw_tracer_acc"]
    if dyc.pallas_microphysics:
        for k in ("fill_q2_zero", "cup_gf_sh", "gfdl_microphysics"):
            per_step[k] = per_leaf[k] = 1
    tree_calls = 1 + REPS * PHASE_INNER if tree else 0
    want = {k: n * (max(1, warmup) + steps + tree_calls)
            + per_leaf[k] * tree_calls for k, n in per_step.items()}
    return per_step, want


def check_launches(label, got, want):
    """Exactly the launches `want` (name: count), no other kernel."""
    wrong = {k: (got.get(k, 0), want.get(k, 0)) for k in set(got) | set(want)
             if got.get(k, 0) != want.get(k, 0)}
    if wrong:
        fail(f"{label}: launches (got, expected) {wrong}")


def print_record(label, rec, card):
    tree = rec.phase_tree or {}
    top = sorted(tree.get("phases_ms", {}).items(), key=lambda kv: -kv[1])[:5]
    print(f"[ci] {label} [{rec.backend}] c{rec.grid['npx']}-L"
          f"{rec.grid['npz']}: median {rec.median_step_s * 1e3:.2f} ms/step, "
          f"{rec.grid_points_per_s:.4e} gridpoints/s over "
          f"{len(rec.step_time_s)} steps (warm-up {rec.compile_time_s:.2f} s;"
          f" mesh: {rec.extra['mesh']}); launches "
          + ", ".join(f"{k} {v}" for k, v in rec.extra["launches"].items())
          + (f"; phase tree: step {tree['full_step_ms']:.2f} ms, top leaves "
             + ", ".join(f"{k} {v:.2f} ms" for k, v in top)
             + f", unaccounted {tree['unaccounted_ms']:.2f} ms"
             if tree else "") + f" ({card})")


def run_ci_pipelines(torch, counters, card):
    """Phase 11: the CI pipelines through the port's dispatch, each in a
    temporary directory, a failed check failing the script.  Every count
    is set to 0 just before each dispatch and read just after; each
    record's own launches (the task's count over its run) must be exactly
    run_launches' for its configuration, its step's share equal to its
    preset's in PATHS, and the records' launches must add up to the
    dispatch's.  Then the c192 Validation on the one card, the smoke
    climatology on the card (the banded remap three times a step), and the
    seven standalone tasks, each column kernel launched exactly once a
    dataset."""
    import tempfile

    from geosongpu_tpu_torch.benchmark.timing import compare
    from geosongpu_tpu_torch.harness.exceptions import CICheckException
    from geosongpu_tpu_torch.harness.task import dispatch, get_config
    from geosongpu_tpu_torch.physics.standalone_gate import N_DATASETS

    def run(exp, action):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            try:
                env = dispatch(exp, action, artifact_directory=f"{td}/art",
                               workspace=f"{td}/ws", device="cuda")
            except CICheckException as e:
                fail(f"{exp} {action}: the task's check failed: {e}")
        torch.cuda.synchronize()
        return env, time.perf_counter() - t0, {
            k: fn.launches for k, fn in counters.items() if fn.launches}

    def check_records(exp, env, key, presets, tree):
        records = env.get(f"{key}.records")
        cfg = env.config
        configs = [cfg.dycore] if not tree else [
            cfg.dycore, dataclasses.replace(
                cfg.dycore, pallas_dycore=True,
                pallas_microphysics=cfg.model == "aquaplanet")]
        total = {}
        for rec, dyc, preset in zip(records, configs, presets):
            per_step, want = run_launches(dyc, cfg.run.steps,
                                          cfg.run.warmup_steps, tree)
            if per_step != PATHS[preset][2]:
                fail(f"{exp} [{rec.backend}]: a step's launches {per_step} "
                     f"are not {preset}'s {PATHS[preset][2]}")
            check_launches(f"{exp} [{rec.backend}]", rec.extra["launches"],
                           want)
            for k, n in rec.extra["launches"].items():
                total[k] = total.get(k, 0) + n
            print_record(exp, rec, card)
        return records, total

    for exp, (key, eager, fused) in CI_BENCHMARKS.items():
        env, sec, got = run(exp, "Benchmark")
        records, total = check_records(exp, env, key, (eager, fused), True)
        del env
        check_launches(f"{exp} Benchmark (the dispatch)", got, total)
        print(f"[ci] {exp} Benchmark through dispatch in {sec:.1f} s: "
              f"fused over eager x"
              f"{compare(*records)['speedup_median_step']:.3f} in the "
              f"median step ({card})")
        torch.cuda.empty_cache()

    env, sec, got = run(CI_VALIDATION, "Validation")
    (rec,), total = check_records(CI_VALIDATION, env, "hs",
                                  ("held_suarez_c48_l72",), False)
    del env
    check_launches(f"{CI_VALIDATION} Validation (the dispatch)", got, total)
    if not rec.extra["mesh"].startswith("single-device"):
        fail(f"{CI_VALIDATION}: mesh {rec.extra['mesh']!r}")
    print(f"[ci] {CI_VALIDATION} Validation through dispatch in {sec:.1f} s, "
          f"its checks passed ({card})")
    torch.cuda.empty_cache()

    env, sec, got = run(CI_CLIMATOLOGY, "Validation")
    cfg, raw = env.config, get_config(CI_CLIMATOLOGY)
    per_day = max(1, int(86400.0 / cfg.dycore.dt))
    every = max(1, per_day // 4)
    steps = (int(raw["spinup_days"] * per_day)
             + -(-int(raw["avg_days"] * per_day) // every) * every)
    check_launches(f"{CI_CLIMATOLOGY} Validation", got,
                   {"remap_banded": 3 * cfg.dycore.k_split * steps})
    if env.get("clim.device") != "cuda":
        fail(f"{CI_CLIMATOLOGY}: ran on {env.get('clim.device')}")
    ubar = env.get("clim.ubar")
    print(f"[ci] {CI_CLIMATOLOGY} Validation through dispatch on "
          f"{env.get('clim.device')} in {sec:.1f} s ({steps} steps of "
          f"c{cfg.dycore.npx}-L{cfg.dycore.npz}, {1e3 * sec / steps:.2f} "
          f"ms/step with the set-up), its HS94 gates passed, max zonal-mean"
          f" u {ubar.max():.2f} m/s ({card})")
    del env

    _, sec, got = run(CI_STANDALONE, "All")
    check_launches(CI_STANDALONE, got, {k: N_DATASETS for k in COLUMN_PHYSICS})
    print(f"[ci] {CI_STANDALONE} through dispatch in {sec:.1f} s: the seven "
          f"tasks' checks passed, each column kernel launched {N_DATASETS} "
          f"times ({card})")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    try:
        from geosongpu_tpu_torch.cli import PRESETS, build_model_for
        from geosongpu_tpu_torch.ops.kernels import build, dsw
        from geosongpu_tpu_torch.ops.kernels import columns as kcol
        from geosongpu_tpu_torch.ops.kernels import microphysics as kmic
        from geosongpu_tpu_torch.ops.kernels import remap as kremap
        from geosongpu_tpu_torch.ops.kernels import standalone_twins as ktw
        from geosongpu_tpu_torch.ops.remap import remap_fields_banded
        from geosongpu_tpu_torch.physics import standalone_gate as gate
    except ImportError as e:
        fail(f"run from the root of a checkout (port not importable: {e})")
    dev = torch.device("cuda")
    counters = {k.__name__: k for k in (
        (kremap.remap_banded,) + dsw.KERNELS + (kmic.gfdl_microphysics,)
        + kcol.KERNELS + ktw.KERNELS)}
    if list(counters) != list(KERNELS):
        fail(f"the wrappers {list(counters)} are not the kernels of KERNELS")

    # ---- 1. device ------------------------------------------------------
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    has_triton = importlib.util.find_spec("triton") is not None
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; triton importable: {has_triton}; "
          f"nvcc: {build.find_nvcc()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"[build] {len(build.sources()[0])} sources: "
          f"{time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s)"
          f" -> {lib.path.parent.name}/{lib.path.name}")
    print_build_log(lib.build_log)
    if "--stages" in sys.argv[1:]:
        if "columns" not in sys.argv[1:]:
            for pname, (form, names, steps) in STAGE_KERNELS.items():
                model = build_model_for(pname)(PRESETS[pname], dev)
                args = kernel_inputs(torch, np, model, dev, steps=steps)
                del model
                stage_times(torch, dsw, args, names, form, card)
                del args
                torch.cuda.empty_cache()
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            for npx in (48, 192):
                preset = PRESETS[REMAP_STAGES[npx]]
                for label, qs, pe1, pe2 in remap_calls(torch, preset, npx, gen,
                                                       dev):
                    a = (qs, pe1, pe2, preset.kord, preset.remap_band)
                    stage_view(torch, f"remap_banded c{npx} {label} {len(qs)}x"
                               f"{tuple(qs[0].shape)}",
                               lambda: kremap.remap_banded(*a),
                               lambda: remap_fields_banded(*a), card, False,
                               reps=20 if npx == 48 else 10)
                    del a, qs, pe1, pe2
                torch.cuda.empty_cache()
        column_stages(torch, gate, kcol, kmic, dev, card)
        return 0
    results = {}   # kernel [form] -> (max_abs_err, ms, plain_ms, bound_ms, by)

    # ---- 3. remap_banded against its plain version ------------------------
    preset = PRESETS["held_suarez_c48_l72"]
    band, K = preset.remap_band, preset.npz
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results["remap_banded"] = check_remap(torch, kremap, remap_fields_banded,
                                          preset, preset.npx, gen, dev, card,
                                          20)
    # more fields than one launch takes (a nonhydrostatic run with two
    # tracers remaps six): the wrapper groups them, two launches here
    lead = (6, preset.npx, preset.npx)
    pe1, pe2 = displaced_coordinates(torch, lead, K, band, gen, dev)
    qs = [(300.0 * (1.0 + 0.1 * torch.randn(lead + (K,), generator=gen,
                                             device=dev)))
          .contiguous() for _ in range(6)]
    before = kremap.remap_banded.launches
    got = kremap.remap_banded(qs, pe1, pe2, preset.kord, band)
    torch.cuda.synchronize()
    if kremap.remap_banded.launches != before + 2:
        fail("remap_banded: 6 fields did not take 2 launches")
    err, rel = compare("remap_banded 6 fields", got,
                       remap_fields_banded(qs, pe1, pe2, preset.kord, band),
                       False)
    k_ms = median_ms(torch, lambda: kremap.remap_banded(
        qs, pe1, pe2, preset.kord, band))
    print(f"[kernel] remap_banded 6 fields 6x{tuple(qs[0].shape)} (2 "
          f"launches): max abs err {err:.3e}, max rel err {rel:.3e}; kernel "
          f"{k_ms:.4f} ms (median of 20; {card})")
    del qs, got
    # the c192-L72 step's three calls, where the card sets the step time
    results["remap_banded c192"] = check_remap(
        torch, kremap, remap_fields_banded,
        PRESETS["held_suarez_c192_l72_fused"], 192, gen, dev, card, 10)

    # ---- 4. the substep kernels against their plain versions ----------
    models = {}

    def model_of(name):
        if name not in models:
            models[name] = build_model_for(name)(PRESETS[name], dev)
        return models[name]

    args = kernel_inputs(torch, np, model_of("held_suarez_c48_l72"), dev)
    check_kernels(torch, dsw, args, list(args), "", card, results)
    a = args["dsw_wind"][:13] + (0.05,)
    err, rel = compare("dsw_wind (vtx_damp 0.05)", dsw.dsw_wind(*a),
                       dsw.dsw_wind_plain(*a), True)
    print(f"[kernel] dsw_wind with vtx_damp 0.05: max abs err {err:.3e}")
    args = kernel_inputs(torch, np, model_of("held_suarez_c48_l72_nh_fused"),
                         dev)
    check_kernels(torch, dsw, args, ["dsw_transport", "dsw_wind"], "nh", card,
                  results)
    check_kernels(torch, dsw, args, ["dsw_tracer", "dsw_nh_pert"], "", card,
                  results)
    args = kernel_inputs(torch, np, model_of("held_suarez_c192_l72_fused"),
                         dev, steps=1)
    check_kernels(torch, dsw, args, ["dsw_wind"], "blend", card, results,
                  reps=10)
    check_kernels(torch, dsw, args, C192_KERNELS, "c192", card, results,
                  reps=10)
    # the terrain term: dsw_csw2 and dsw_wind on the JW06 model's inputs,
    # whose context carries the balancing surface geopotential
    jw = model_of(JW_PRESET)
    phis = float(jw.ctx.metrics.phis.abs().max())
    if not phis > 1e3:
        fail(f"the JW06 context's terrain is flat (max|phis| {phis})")
    args = kernel_inputs(torch, np, jw, dev)
    check_kernels(torch, dsw, args, ["dsw_csw2", "dsw_wind"], "jw", card,
                  results)
    for key in ("dsw_csw2 jw", "dsw_wind jw"):
        if results[key][0] != 0.0:
            fail(f"{key}: {results[key][0]:.3e} from its plain version with "
                 f"terrain, not 0.0")
    print(f"[kernel] dsw_csw2 and dsw_wind with the JW06 terrain (max|phis| "
          f"{phis:.1f} m2/s2): 0.0 from their plain versions")
    del args, a
    torch.cuda.empty_cache()

    # ---- 5. the column-physics kernels against their plain versions ------
    check_column_physics(torch, np, gate,
                         model_of("aquaplanet_c48_l32_fused"), dev, card,
                         results)

    # ---- 6. the dual-build gate of the physics kernels, as a path ---------
    launches = {"gate": run_gate_path(torch, gate, counters, dev, card)}

    # ---- 7. the seven model paths ------------------------------------------
    step_ms = {}
    for pname, (label, steps, per_step) in PATHS.items():
        step_ms[label], launches[label] = run_preset(
            torch, np, model_of(pname), counters, label, card, steps,
            per_step)
    print("[main] in one call: " + ", ".join(
        f"{label} {ms:.2f} ms/step" for label, ms in step_ms.items())
        + f" ({card})")

    # ---- 8. profiler window ---------------------------------------------
    for pname, (label, _, _) in PATHS.items():
        profile_steps(torch, model_of(pname), label, card)
    models.clear()
    torch.cuda.empty_cache()

    # ---- 9. card against CPU ----------------------------------------------
    card_vs_cpu(torch, np, "held_suarez_c48_l72", dev, "eager")
    card_vs_cpu(torch, np, "held_suarez_c48_l72_fused", dev, "fused")
    card_vs_cpu(torch, np, "held_suarez_c48_l72_nh_fused", dev, "nh")
    card_vs_cpu(torch, np, "held_suarez_c48_l72_fused", dev, "blend",
                damping_exchange="blend")
    card_vs_cpu(torch, np, "aquaplanet_c48_l32_fused", dev, "aqua",
                size=(8, 12, 4))
    card_vs_cpu(torch, np, JW_PRESET, dev, "jw", size=(12, 26, 2),
                noise_floor=True)

    # ---- 10. the JW06 validation through the port's dispatch --------------
    check_jw_steady_day(torch, dev, card)
    run_jw_validation(torch, counters, card)

    # ---- 11. the CI pipelines through the port's dispatch ---------------
    run_ci_pipelines(torch, counters, card)

    # each entry: (key of results, kernel, path whose launches it reports)
    entries = [(k, k, "fused") for k in list(KERNELS)[:6]] + [
        ("dsw_wind blend", "dsw_wind", "c192"),
        ("dsw_transport nh", "dsw_transport", "nh"),
        ("dsw_wind nh", "dsw_wind", "nh"),
        ("dsw_tracer", "dsw_tracer", "nh"),
        ("dsw_nh_pert", "dsw_nh_pert", "nh"),
        ("gfdl_microphysics", "gfdl_microphysics", "aqua"),
        ("fill_q2_zero", "fill_q2_zero", "aqua")] + [
        (k, k, "aqua" if k == "cup_gf_sh" else "gate")
        for k in COLUMN_PHYSICS[2:]] + [
        ("dsw_csw2 jw", "dsw_csw2", "jw"), ("dsw_wind jw", "dsw_wind", "jw")]
    for key, k, path in entries:
        if launches[path][k] < 1:
            fail(f"{key}: not launched on the {path} path")
    def rows(entries):
        return [{
            "name": key,
            "route": "cuda",
            "source": f"geosongpu_tpu_torch/csrc/{KERNELS[k][0]}",
            "replaces": KERNELS[k][1],
            "launches": launches[path][k],
            "max_abs_err": results[key][0],
            "ms": results[key][1],
            "plain_ms": results[key][2],
            "bound_ms": results[key][3],
            "bound_by": results[key][4],
            "library_ms": None,
        } for key, k, path in entries]

    print(json.dumps({"kernels_c192": rows(
        [(f"{k} c192", k, "c192")
         for k in C192_KERNELS + ["remap_banded"]])}))
    print(json.dumps({"kernels": rows(entries)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

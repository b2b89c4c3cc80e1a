#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, and exits non-zero
on any failure (and when no CUDA device is present).

    python3 chip_smoke.py --stages

runs phases 1 and 2 and then only the per-stage view of the fvtp2d
callers, dsw_csw1, dsw_nh_pert, nh_vertical_solve and the blend dsw_wind
at c192-L72 (STAGE_KERNELS), of remap_banded at
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
`--stages columns` runs the column view alone.  `--stages solve` runs
nh_vertical_solve alone: on the NH preset's inputs and on synthetic
columns at c192-L72's padded shape (SOLVE_STAGE_SHAPE: 235,224 columns,
made as tests/test_torch_cuda.py::_synthetic_args makes them), each equal
to its plain version in every element (NaN only where plain has NaN), with
its bound, the device time's share of it and the launch configuration the
profiler records (grid, block, registers, shared memory, blocks an SM);
the full `--stages` takes the c192 view too.

    python3 chip_smoke.py --harness

runs phases 1, 2 and 13 alone, and `--tools` phases 1, 2 and 15.
Without arguments, the phases:

1. device: the card's name and power limit (nvidia-smi), the toolchain,
   NVML's software version and power limit (which must equal
   nvidia-smi's), and the idle power before any work is queued (10 NVML
   samples at 0.2 s), which phase 11 compares against;
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
   dsw_nh_pert, dsw_wind with the p', phi', rho terms) and
   nh_vertical_solve (the vertical glue between them, equal to its plain
   version in every element over every column, NaN only where the plain
   version has NaN) at c48-L72 on a nonhydrostatic state; at c192-L72,
   where the card and not the host sets the time, the five kernels the
   c192 preset launches (dsw_wind in its blend form); dsw_csw2 and
   dsw_wind on the JW06 preset's inputs (perturbed init + 2 steps, its
   balancing terrain in the metrics), where each must equal its plain
   version (0.0).
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
   device events per step and the top device kernels, and each preset's
   idle share (1 - busy / phase 7's ms/step);
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
   launched exactly once a dataset.  The two Benchmark pairs and the c192
   Validation run with HARDWARE_SAMPLING=1 (set around those dispatches
   only): every record carries energy, the card's energy counter rose over
   each timed window at a mean power of at most 1.05 x the power limit,
   and the device-bound c192 Validation's mean power exceeds phase 1's
   idle power; each record prints its J, J/step and mean W from the
   counter beside the sampled power's trapezoid, and each pair its
   eager/fused energy ratio;
12. the hardware sampler and the trace reader on the card: NVML's
   utilization and power over 10 idle samples, 3 s of chained matmuls
   (a load) and 10 idle samples, higher under the load than in either
   idle stretch; the hws server as a subprocess (`hws.cli server --device
   cuda`) answering the client's start, tick, dump and stop, its dump
   loaded by the port's load_data; the Chrome trace of 2 fused c48-L72
   steps through benchmark.profiler.trace, whose device-interval union
   (hws.xprof_util.device_busy) equals the profiler's device-event total
   within 2%; and the device-bound fused c192-L72 preset's median step
   with the sampler (a sample after each step) within 2% of its median
   without;
13. the host bridge, checkpoint and jobs on the main path's preset
   (BRIDGE_PRESET, bench.py's fused c48-L72): the bridge of
   interop/def_dycore.json generated into a temporary directory, the
   port's DycoreHook on the card, and interop/dycore_host.c compiled with
   gcc against the generated C source and libpython, stepping the model 3
   times from Fortran-order files as a Fortran host would; the 14 state
   fields equal 3 direct steps in this process bit for bit, the host
   process's launches exactly 3 x PATHS' per step (18 each of the four
   substep kernels, 6 of dsw_tracer_acc, 9 of remap_banded), validate_run
   0 on an equal and 1 on a changed copy of u, the bridged and the direct
   ms per step printed; then 2 steps, a checkpoint saved and restored into
   a fresh model and 2 steps, equal bit for bit to 4 straight steps, with
   exact launches, the checkpoint's bytes and the save and restore
   seconds; then ci-heartbeat, ci-clean and ci-info on the card through
   dispatch (ci_info.devices names the card), a LocalBackend job of
   GPUJobConfig.one_gpu() with the hardware sampler around `cli run` of the
   preset (COMPLETED; its dump holds samples with power > 0 and the card's
   UUID), and a job whose payload exits 1 (FAILED);
14. the sharded step on stacked ranks (all ranks of a layout in one
   process on the card): the fused c48-L72 preset on the faces-local
   (2, 4) layout (48 slots of 24 x 12 blocks) and the face-sharded
   (6, 2, 2) one, the fused c192-L72 blend form on (6, 1, 1), and the
   eager c48-L72 with overlap_fills and rim_split on (2, 4); each one step
   against the single-device step from the JW06 flow (u, v, delp, pt, ps
   within 1e-5 of max|single|, no floor) and from the perturbed rest
   start (with omga; winds within 6e-3 m/s), with exact launches and
   ms/step of both forms; every substep kernel and remap_banded against
   its plain version on the (2, 4) blocks, with its device time; then
   held_suarez_c16_sharded on 8 stacked ranks and scaling_bench through
   dispatch.  `--sharded` runs phases 1, 2 and 14 alone;
15. the tools on the card's output: (a) phase 9's fused case, card and CPU
   written as .npz with state_to_numpy, through the port's validation CLI
   (`validate CPU CARD VAR --rel_tol 1e-4` returns 0 for delp, pt and ps;
   ua and va printed without a gate), and check_tolerance must refuse pt
   + 0.5 K; (b) one fused c48-L72 step on the faces-local (2, 4) layout
   from the JW06 flow, each of the 48 slots' centred fields (delp, pt, ps,
   ua, va) written with write_fixture as the Serialbox rank of its face and
   block, converted by `serialbox DIR OUT -l 4,2 -f npz` (SERIALBOX_PYTHON
   at validation/serialbox_python, the reader of that layout) and equal to
   the step's unplaced global fields bit for bit; (c) the tool scripts'
   twins (geosongpu_tpu_torch/scripts/): bench_ladder's rungs c48 and c192
   (5 timed steps, both finite), phase_profile and the roofline of the
   fused c48-L72 preset (3 traced steps; each kernel's bytes a step within
   1% of phase 3/4's bound bytes, the kernels' device time at most the
   trace's busy time; printed also on the (2, 4) blocks) and the HS
   climatology at c12-L20 over 1 + 1 days (finite (32, 20) means).
   `--tools` runs phases 1, 2 and 15 alone.

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
recurrence down the column, and PyTorch has no batched tridiagonal solver
for nh_vertical_solve (a dense torch.linalg.solve is another function) -
so library_ms is null throughout.  nh_vertical_solve replaces no Pallas
kernel: its "replaces" names the reference's lax.scan pair, which runs the
same solve on the TPU as XLA glue.
"""
import contextlib
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

try:
    # the bound's bytes and operations, as the roofline script counts them
    from geosongpu_tpu_torch.benchmark.bounds import (METRICS_READ,
                                                      OPS_PER_POINT, bound,
                                                      moved_bytes, tensors_of)
except ImportError as e:
    sys.exit(f"chip_smoke FAILED: run from the root of a checkout with torch "
             f"installed ({e})")

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
    "nh_vertical_solve": ("nh_vertical_solve.cu",
                          "geosongpu_tpu/dycore/nh_solver.py:57", False),
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
COLUMN_PHYSICS = list(KERNELS)[list(KERNELS).index("gfdl_microphysics"):]
# the kernels that must equal their plain versions in every element, NaN
# only where the plain version has NaN (the substep's padded columns)
NAN_AS_PLAIN = ("nh_vertical_solve",)
# the column kernels that must equal their plain versions in every element
# (the other three keep REL_GATE)
EXACT = ("gfdl_microphysics", "fill_q2_zero", "cup_gf_sh", "aer_activation")
# the pointwise column kernels, in the order --stages columns takes them
POINTWISE = ("cup_gf_sh", "aer_activation", "evap_subl_pdf", "buoyancy",
             "moist_rad_coup")
# __global__ stages of csrc/*.cu, as the profiler names them;
# blend_divergence (the blend dsw_wind's separate pass before it was folded
# into wind_update's tile) stays only while --stages must read an older tree
PORT_STAGES = ("::csw1(", "::csw2_winds(", "::fvtp2d_tile<",
               "::transport_update(", "::nh_transport_update(",
               "::tracer_update(", "::tracer_sub_update(", "::wind_update<",
               "::blend_divergence(", "::hydro_columns(", "::nh_columns(",
               "::nh_vertical_columns(",
               "::remap_banded_kernel<", "::gfdl_microphysics_columns(",
               "::fill_q2_zero_columns(", "::aer_activation_points",
               "::moist_rad_coup_points(", "::cup_gf_sh_points(",
               "::buoyancy_points(", "::evap_subl_pdf_points(")
# --stages: preset -> (form, kernels, steps before the inputs are taken)
STAGE_KERNELS = {
    "held_suarez_c48_l72": ("c48", ["dsw_csw1", "dsw_transport",
                                    "dsw_tracer_acc"], 2),
    "held_suarez_c48_l72_nh_fused": ("nh", ["dsw_transport", "dsw_tracer",
                                            "dsw_nh_pert",
                                            "nh_vertical_solve"], 2),
    "held_suarez_c192_l72_fused": ("c192", ["dsw_csw1", "dsw_transport",
                                            "dsw_tracer_acc", "dsw_wind"],
                                   1),
}
# --stages also takes remap_banded at the step's three calls of these
# presets' widths (within REL_GATE: the view can run on an older tree)
REMAP_STAGES = {48: "held_suarez_c48_l72", 192: "held_suarez_c192_l72_fused"}
# --stages also takes the column kernels at these (columns, K): the
# physics gate's, the aquaplanet model's and c192-L72's column count
COLUMN_STAGES = ((128, 40), (6 * 48 * 48, 32), (6 * 192 * 192, 72))
# --stages: nh_vertical_solve also on synthetic columns of c192-L72's padded
# shape [F, Ny, Nx, K], where the columns take many waves of blocks
SOLVE_STAGE_SHAPE = (6, 198, 198, 72)
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
        "dsw_tracer": 6, "dsw_nh_pert": 6, "nh_vertical_solve": 6,
        "remap_banded": 3}),
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
# phase 14, the sharded step on stacked ranks: the main path's preset on
# the (2, 4), (6, 2, 2) layouts, c192 on (6, 1, 1), the eager form with
# overlap_fills and rim_split; each step against the single-device step,
# from the JW06 flow (its jets on the preset's grid and levels) and from
# the perturbed rest start
SHARDED_PRESET = "held_suarez_c48_l72_fused"
SHARDED_EXPERIMENT = "held_suarez_c16_sharded"
SHARDED_FIELDS = ("u", "v", "delp", "pt", "ps", "omga")
SHARDED_GATE = 1e-5      # relative to max|single|; winds SLICE_WIND_ATOL
# from the flow, relative to max|single|, no floor: along a face-edge halo
# strip the chart resample of the A-grid winds reads one cell past a
# block's end, clamped there (as in the JAX package's sharded step), and
# moves u by 1.7e-4 of max|u| in one c48-L72 (2,4) step; gates forced on
# in every block or dropped D-grid signs move it by 0.15-0.34.
# omga, a small residual of large terms there, is gated from the rest start
FLOW_FIELDS = ("u", "v", "delp", "pt", "ps")
FLOW_GATE = 1e-3
FORCING_ULP = 4
SHARDED_REPS = 3
# phase 13, the host bridge, checkpoint and jobs: the main path's preset
# (bench.py's configuration), stepped BRIDGE_STEPS times through the C host
BRIDGE_PRESET = "held_suarez_c48_l72_fused"
BRIDGE_STEPS = 3
# phase 15, the tools on the card's output: the validation CLI's gate
# (relative RMS, card against CPU) on these fields, the fields it prints
# without one (winds: an absolute floor, SLICE_WIND_ATOL), the centred
# fields written as Serialbox ranks (the converter stitches blocks without
# dropping shared interfaces, so a staggered field would come back n + py
# rows), and the twins' sizes
TOOLS_REL_TOL = 1e-4
TOOLS_GATED = ("delp", "pt", "ps")
TOOLS_PRINTED = ("ua", "va")
SERIALBOX_FIELDS = ("delp", "pt", "ps", "ua", "va")
TOOLS_LADDER_STEPS = 5
TOOLS_ROOFLINE_STEPS = 3
TOOLS_BYTES_TOL = 0.01


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


def equal_to_plain(label, got, want):
    """Fails unless every output equals its plain version in every element,
    a NaN counting as equal where the plain version has NaN (and nowhere
    else).  Returns the number of NaN both hold."""
    nans = 0
    for n, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            fail(f"{label} output {n}: shape {tuple(g.shape)} vs plain "
                 f"{tuple(w.shape)}")
        both = g.isnan() & w.isnan()
        same = (g == w) | both
        if not bool(same.all()):
            d = (g - w).abs()[~same]
            fail(f"{label} output {n}: {int((~same).sum())} elements differ "
                 f"from the plain version (max {float(d.max()):.3e}; NaN in "
                 f"kernel {int(g.isnan().sum())}, plain "
                 f"{int(w.isnan().sum())})")
        nans += int(both.sum())
    return nans


def kernel_inputs(torch, np, model, dev, steps=2, sharded=None):
    """{kernel name: args} at the model's shapes from a real state: init
    (3 K of pt noise, a tracer 1 + 0.2 U[0,1); JW06: the perturbed
    state), `steps` steps, fill, then
    one substep of plain versions in the model's own mode (damping form,
    nonhydrostatic fields, per-substep tracers); in z_tracer mode
    dsw_tracer_acc takes the substep's winds and mass fluxes accumulated
    over n_split substeps and split in q_split subcycles.  sharded: the
    (place, step) of a sharded stepper: the steps and the substep then run
    on its stacked blocks, through its context (step.ctx)."""
    from geosongpu_tpu_torch.dycore.fv_dynamics import _use_exchange
    from geosongpu_tpu_torch.dycore.sw import fill_substep
    from geosongpu_tpu_torch.dycore.sw_fused import substep_kernel_args

    cfg, ctx = model.config, model.ctx
    st = model.init(perturb=3.0)
    rng = np.random.default_rng(5)
    st.q = torch.as_tensor((1.0 + 0.2 * rng.random(tuple(st.q.shape)))
                           .astype(np.float32), device=dev)
    if sharded is None:
        st = model.run(st, steps)
    else:
        place, step = sharded
        ctx, st = step.ctx, place(st)
        for _ in range(steps):
            st = step(st)
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
        if kname in NAN_AS_PLAIN:
            nans = equal_to_plain(key, got, want)
            err = rel = 0.0
            print(f"[kernel] {key}: equal to its plain version in every "
                  f"element of {sum(g.numel() for g in got)} ({nans} NaN "
                  f"in both)")
        else:
            err, rel = compare(key, got, want, KERNELS[kname][2])
        k_ms = median_ms(torch, lambda: kern(*a), reps=reps)
        p_ms = median_ms(torch, lambda: plain(*a), reps=reps)
        by = bound(key if key in OPS_PER_POINT else kname,
                   tensors_of(a, METRICS_READ.get(
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


def launch_configs(prof):
    """{__global__ stage: its launch configuration} of a torch.profiler
    window, as the trace records it (grid, block, registers, shared
    memory, blocks an SM)."""
    import tempfile

    keys = ("grid", "block", "registers per thread", "shared memory",
            "blocks per SM", "est. achieved occupancy %")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out = {}
    for ev in events:
        name = ev.get("name", "")
        if ev.get("cat") == "kernel" and any(s in name for s in PORT_STAGES):
            stage = name.split("::")[1].split("(")[0]
            args = ev.get("args", {})
            out.setdefault(stage, {k: args[k] for k in keys if k in args})
    return out


def stage_view(torch, label, kern, plain, card, exact, reps=20,
               bound_of=None, nan_as_plain=False, configs=False):
    """--stages: one kernel call against its plain version (0.0 with
    `exact`, else within REL_GATE), its median time over `reps` calls, and
    the device time per launch of each __global__ it runs and of all its
    device work per call in a profiler window of 10 calls; with
    `bound_of(outputs) -> (ms by bytes, ms by operations)`, also the bound
    and the share of it that the device time reaches.  nan_as_plain: exact,
    a NaN allowed where the plain version has one (equal_to_plain).
    configs: also the launch configuration of each __global__."""
    from torch.profiler import ProfilerActivity, profile

    got, want = outputs_of(kern()), outputs_of(plain())
    torch.cuda.synchronize()
    if nan_as_plain:
        equal_to_plain(label, got, want)
        err = 0.0
    elif exact:
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
    if total <= 0.0:
        fail(f"{label}: the profiler window holds no device time")
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
    if configs:
        for stage, cfg in launch_configs(prof).items():
            print(f"[stages] {label}: {stage} launch " + ", ".join(
                f"{k} {v}" for k, v in cfg.items()))


def stage_times(torch, dsw, args, names, form, card, reps=20):
    """--stages of the substep kernels `names` on `args` (0.0 each);
    nh_vertical_solve with its bound and launch configuration."""
    for name in names:
        a = args[name]
        solve = name == "nh_vertical_solve"
        stage_view(torch, f"{name} {form} {tuple(a[0].shape)}",
                   lambda: getattr(dsw, name)(*a),
                   lambda: getattr(dsw, name + "_plain")(*a), card, True,
                   reps, nan_as_plain=name in NAN_AS_PLAIN,
                   bound_of=(lambda out: bound(name, tensors_of(a, ()), out))
                   if solve else None, configs=solve)


def solve_stage(torch, np, dsw, dev, card, seed=11):
    """--stages of nh_vertical_solve on synthetic columns at
    SOLVE_STAGE_SHAPE, made as tests/test_torch_cuda.py::_synthetic_args
    makes them (layer w 0.3 u, delz 80 + 8 u, pt 300 + 10 u, delp 1000 +
    100 u, u uniform in [-1, 1]; dt and ptop 100): equal to its plain
    version in every element, with its bound and the device time's share
    of it."""
    rng = np.random.default_rng(seed)
    shape = SOLVE_STAGE_SHAPE
    u = lambda: rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev)
    a = (t(0.3 * u()), t(80.0 + 8.0 * u()), t(300.0 + 10.0 * u()),
         t(1000.0 + 100.0 * u()), 100.0, 100.0)
    stage_view(torch, f"nh_vertical_solve synthetic {shape}",
               lambda: dsw.nh_vertical_solve(*a),
               lambda: dsw.nh_vertical_solve_plain(*a), card, True, reps=10,
               bound_of=lambda out: bound("nh_vertical_solve",
                                          tensors_of(a, ()), out),
               nan_as_plain=True, configs=True)
    del a
    torch.cuda.empty_cache()


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
                       lambda out: bound(name, tensors_of(reads, ()),
                                         out))
        del d, a, q, dp, args, reads
        torch.cuda.empty_cache()


def remap_calls(torch, preset, npx, gen, dev, block=None):
    """The three remap calls of a step of `preset` at c`npx`, on a smooth
    Lagrangian displacement (displaced_coordinates): pt and the tracer,
    then the D-grid winds u and v on their staggered columns.  block: (F,
    ny, nx) of a sharded step's stacked blocks, in place of 6 faces of
    npx x npx.  Yields (label, qs, pe1, pe2)."""
    K, band = preset.npz, preset.remap_band
    F, ny, nx = block if block is not None else (6, npx, npx)
    for label, lead, nf, scale in (("pt+q", (F, ny, nx), 2, 300.0),
                                   ("u", (F, ny + 1, nx), 1, 10.0),
                                   ("v", (F, ny, nx + 1), 1, 10.0)):
        pe1, pe2 = displaced_coordinates(torch, lead, K, band, gen, dev)
        qs = [(scale * (1.0 + 0.1 * torch.randn(lead + (K,), generator=gen,
                                                device=dev))).contiguous()
              for _ in range(nf)]
        yield label, qs, pe1, pe2


def check_remap(torch, kremap, plain, preset, npx, gen, dev, card, reps,
                block=None):
    """Phase 3 at c`npx` (or on stacked blocks, remap_calls): each of a
    step's three remap calls against the plain version, with its error,
    median times and bound; returns the step's (max_abs_err, ms, plain_ms,
    bound_ms, bound_by)."""
    kord, band = preset.kord, preset.remap_band
    max_abs_err, kernel_ms, plain_ms, by = 0.0, 0.0, 0.0, [0.0, 0.0]
    for label, qs, pe1, pe2 in remap_calls(torch, preset, npx, gen, dev,
                                           block):
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
    by = bound(name, tensors_of(reads, ()), got, points)
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


def check_launches_of(label, launches, per_step, steps):
    """Each kernel launched exactly per_step[kernel] x steps times."""
    for k, got in launches.items():
        if got != per_step.get(k, 0) * steps:
            fail(f"{label}: {k} launched {got} times in {steps} steps, "
                 f"expected {per_step.get(k, 0) * steps}")


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
    check_launches_of(label, launches, per_step, n)
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
    return a, b


def profile_steps(torch, model, label, card, steps=2):
    """Device time, device events and the top ops over `steps` steps, after
    one profiled step that absorbs the profiler's own start-up.  Returns
    (device busy ms/step, device events/step)."""
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
                key = stage[2:].rstrip("(<")
                t0, c0 = stages.get(key, (0.0, 0))
                stages[key] = (t0 + t, c0 + c)
    print(f"[profile] {label}: the port's stages, ms/step (launches/step): "
          + ", ".join(f"{k} {t / steps / 1e3:.3f} ({c / steps:.0f})"
                      for k, (t, c) in sorted(stages.items(),
                                              key=lambda kv: -kv[1][0])))
    top = sorted(stats.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        print(f"[profile]   {t / steps / 1e3:8.3f} ms/step {c / steps:7.0f}"
              f"/step  {name[:90]}")
    return busy, n_events / steps


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
    check_launches_of(JW_EXPERIMENT, launches, PATHS[JW_PRESET][2], steps)
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


def check_energy(exp, rec, limit_w, card):
    """A sampled record (HARDWARE_SAMPLING=1): it carries energy, the card's
    counter rose over the timed window, and the window's mean power is at
    most 1.05 x the power limit.  Prints the counter's energy beside the
    trapezoid of the sampled power over the samples' own span (NVML's
    running average lags the load) and the counter over that
    span."""
    from geosongpu_tpu_torch.hws.analysis import load_data

    if not rec.energy:
        fail(f"{exp} [{rec.backend}]: no energy in the sampled record")
    x = rec.extra
    j, w = x["gpu_energy_j_counter"], x["mean_gpu_power_w"]
    if not j > 0:
        fail(f"{exp} [{rec.backend}]: the energy counter read {j} J over "
             f"{x['window_s']:.3f} s")
    if not w <= 1.05 * limit_w:
        fail(f"{exp} [{rec.backend}]: mean power {w:.2f} W over 1.05 x the "
             f"{limit_w:.2f} W limit")
    d = load_data(x["hws_dump"])
    span_j = (int(d["energy_mj"][-1]) - int(d["energy_mj"][0])) / 1e3
    samples = x["gpu_energy_j_samples"]
    print(f"[energy] {exp} [{rec.backend}]: {j:.2f} J over "
          f"{x['window_s']:.3f} s of {len(rec.step_time_s)} steps, "
          f"{x['j_per_step']:.3f} J/step, mean {w:.2f} W (the counter; "
          f"tpu_kwh {rec.energy['tpu_kwh']:.4e}); over the samples' span "
          f"{float(d['t_s'][-1]):.3f} s the counter {span_j:.2f} J, the "
          f"sampled power's trapezoid {samples:.2f} J"
          + (f" ({(samples / span_j - 1) * 100:+.1f}%)" if span_j > 0 else "")
          + f"; host model {rec.energy['cpu_kwh'] * 3.6e6:.2f} J ({card})")
    return w


def run_ci_pipelines(torch, counters, card, limit_w, idle_w):
    """Phase 11: the CI pipelines through the port's dispatch, each in a
    temporary directory, a failed check failing the script.  Every count
    is set to 0 just before each dispatch and read just after; each
    record's own launches (the task's count over its run) must be exactly
    run_launches' for its configuration, its step's share equal to its
    preset's in PATHS, and the records' launches must add up to the
    dispatch's.  The Benchmark pairs and the c192 Validation run with
    HARDWARE_SAMPLING=1 (set around those calls only): each record's
    energy passes check_energy, and the c192 Validation's mean power
    (device-bound) exceeds the idle power of phase 1.  Then the smoke
    climatology on the card (the banded remap three times a step), and the
    seven standalone tasks, each column kernel launched exactly once a
    dataset."""
    import tempfile

    from geosongpu_tpu_torch.benchmark.timing import compare
    from geosongpu_tpu_torch.harness.exceptions import CICheckException
    from geosongpu_tpu_torch.harness.task import dispatch, get_config
    from geosongpu_tpu_torch.physics.standalone_gate import N_DATASETS

    def run(exp, action, sampled_key=None):
        """sampled_key: the task's env key; its records are sampled and
        their energy checked while the dumps exist."""
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if sampled_key:
            os.environ["HARDWARE_SAMPLING"] = "1"
        try:
            with tempfile.TemporaryDirectory() as td:
                try:
                    env = dispatch(exp, action,
                                   artifact_directory=f"{td}/art",
                                   workspace=f"{td}/ws", device="cuda")
                except CICheckException as e:
                    fail(f"{exp} {action}: the task's check failed: {e}")
                if sampled_key:
                    env.set("hws.mean_w", [
                        check_energy(exp, rec, limit_w, card)
                        for rec in env.get(f"{sampled_key}.records")])
        finally:
            os.environ.pop("HARDWARE_SAMPLING", None)
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
        env, sec, got = run(exp, "Benchmark", key)
        records, total = check_records(exp, env, key, (eager, fused), True)
        del env
        check_launches(f"{exp} Benchmark (the dispatch)", got, total)
        c = compare(*records)
        j = [r.extra["gpu_energy_j_counter"] for r in records]
        print(f"[ci] {exp} Benchmark through dispatch in {sec:.1f} s: "
              f"fused over eager x{c['speedup_median_step']:.3f} in the "
              f"median step; energy eager over fused x"
              f"{c['energy_ratio']:.3f} (compare: card and host model), "
              f"card alone x{j[0] / j[1]:.3f} ({j[0]:.2f} J / {j[1]:.2f} J; "
              f"{card})")
        torch.cuda.empty_cache()

    env, sec, got = run(CI_VALIDATION, "Validation", "hs")
    (rec,), total = check_records(CI_VALIDATION, env, "hs",
                                  ("held_suarez_c48_l72",), False)
    (mean_w,) = env.get("hws.mean_w")
    del env
    check_launches(f"{CI_VALIDATION} Validation (the dispatch)", got, total)
    if not rec.extra["mesh"].startswith("single-device"):
        fail(f"{CI_VALIDATION}: mesh {rec.extra['mesh']!r}")
    if not mean_w > idle_w:
        fail(f"{CI_VALIDATION}: mean power {mean_w:.2f} W over its steps is "
             f"not above the idle {idle_w:.2f} W")
    print(f"[ci] {CI_VALIDATION} Validation through dispatch in {sec:.1f} s, "
          f"its checks passed; mean power {mean_w:.2f} W against "
          f"{idle_w:.2f} W idle ({card})")
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


def sample_idle(sampler, n=10):
    """n samples rate_s apart with nothing queued on the card; their mean
    power (W) and busy share."""
    k = len(sampler.data["tpu_psu"])
    for _ in range(n):
        sampler.sample_once()
        time.sleep(sampler.rate_s)
    return (statistics.fmean(sampler.data["tpu_psu"][k:]),
            statistics.fmean(sampler.data["tpu_busy"][k:]))


def counter_steps(gpu, seconds=1.0):
    """The energy counter polled every millisecond for `seconds`: how
    often its value changes (the median interval between changes, s) and
    how many times."""
    changes, last = [], gpu.energy_mj()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        e = gpu.energy_mj()
        if e != last:
            changes.append(time.perf_counter())
            last = e
        time.sleep(0.001)
    gaps = [b - a for a, b in zip(changes, changes[1:])]
    return (statistics.median(gaps) if gaps else float("nan")), len(changes)


def check_idle_and_busy(torch, dev, card):
    """Phase 12.1: how often the energy counter steps (1 s of polling),
    then 10 idle samples at 0.2 s, 3 s of chained float32 matmuls (a load,
    not a kernel under test) with a sample every 0.2 s between its
    synchronised batches, 10 idle samples: the NVML utilization and power
    under load exceed both idle stretches'.  Also prints the host's CPU
    utilization under the load, as the sampler reads it from /proc/stat."""
    from geosongpu_tpu_torch.hws.server import Sampler

    with contextlib.closing(Sampler(rate_s=0.2, device=dev)) as sampler:
        step_s, n_steps = counter_steps(sampler.gpu)
        print(f"[hws] the energy counter changed {n_steps} times in 1 s of "
              f"polling, a median {step_s:.4f} s apart ({card})")
        before = sample_idle(sampler)
        k = len(sampler.data["tpu_psu"])
        a = torch.randn(8192, 8192, device=dev)
        t0 = last = time.perf_counter()
        while time.perf_counter() - t0 < 3.0:
            for _ in range(4):
                a = torch.tanh(a @ a)
            torch.cuda.synchronize()
            if time.perf_counter() - last >= sampler.rate_s:
                sampler.sample_once()
                last = time.perf_counter()
        load = (statistics.fmean(sampler.data["tpu_psu"][k:]),
                statistics.fmean(sampler.data["tpu_busy"][k:]))
        n_load = len(sampler.data["tpu_psu"]) - k
        host = statistics.fmean(sampler.data["cpu_exe_utl"][k:])
        del a
        after = sample_idle(sampler)
    print(f"[hws] idle {before[0]:.2f} W busy {before[1]:.3f}; under load "
          f"{load[0]:.2f} W busy {load[1]:.3f} ({n_load} samples over 3 s, "
          f"NVML's averaged power lags); idle after {after[0]:.2f} W "
          f"busy {after[1]:.3f} (NVML, 0.2 s apart; {card}); the host's "
          f"CPU under the load {host:.2f}% busy (/proc/stat)")
    for i, what in enumerate(("power", "busy")):
        if not load[i] > max(before[i], after[i]):
            fail(f"hws: {what} under load {load[i]} is not above idle "
                 f"{before[i]} / {after[i]}")


def check_server(card, name):
    """Phase 12.2: the hws server as a subprocess on the card, the client's
    start, tick, dump and stop; the dump loads with the port's load_data.
    The socket directory is a relative path under the working directory,
    which keeps the socket's path far below the 108 bytes of a unix
    socket address."""
    import shutil
    import tempfile

    from geosongpu_tpu_torch.hws import constants
    from geosongpu_tpu_torch.hws.analysis import load_data
    from geosongpu_tpu_torch.hws.client import client_main

    sock = os.path.relpath(tempfile.mkdtemp(prefix=".hws_", dir="."))
    proc = subprocess.Popen(
        [sys.executable, "-m", "geosongpu_tpu_torch.hws.cli", "server",
         "--device", "cuda", "--socket_dir", sock, "--dump_dir", sock,
         "--rate", "0.1"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        t0 = time.perf_counter()
        while not os.path.exists(constants.socket_path(sock)):
            if proc.poll() is not None or time.perf_counter() - t0 > 120:
                proc.kill()
                fail(f"hws server did not start: {proc.communicate()}")
            time.sleep(0.1)
        replies = [client_main("start", sock)]
        time.sleep(1.0)
        replies.append(client_main("tick", sock))
        time.sleep(0.5)
        replies += [client_main("dump", sock), client_main("stop", sock)]
        out, err = proc.communicate(timeout=60)
        if proc.returncode != 0 or any(r.get("status") != "ok"
                                       for r in replies):
            fail(f"hws server: rc {proc.returncode}, replies {replies}, "
                 f"{err[-2000:]}")
        d = load_data(replies[2]["path"])
        n = len(d["t_s"])
        if n < 1 or str(d["device"]) != "cuda" or str(d["gpu_name"]) != name:
            fail(f"hws server's dump: {n} samples, {d['device']}, "
                 f"{d['gpu_name']}")
        print(f"[hws] server subprocess on the card: start, tick, dump, "
              f"stop answered ok; {n} samples over {float(d['t_s'][-1]):.2f}"
              f" s, tick at {d['ticks'].tolist()}, power "
              f"{statistics.fmean(d['tpu_psu']):.2f} W mean; started in "
              f"{time.perf_counter() - t0:.1f} s all told ({card})")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(sock, ignore_errors=True)


def check_trace_union(torch, model, card, steps=2):
    """Phase 12.3: 2 fused c48-L72 steps under benchmark.profiler.trace,
    after one profiled step that absorbs the profiler's start-up (as phase
    8): the union of the Chrome trace's device intervals
    (hws.xprof_util.device_busy) equals the profiler's device-event total
    (device_times, phase 8's sum) within 2% - one stream, no overlap."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from geosongpu_tpu_torch.benchmark.profiler import trace
    from geosongpu_tpu_torch.hws.xprof_util import device_busy

    s = model.run(model.init(perturb=1e-3), 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        s = model.step(s)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as td:
        with trace(td, "cuda") as prof:
            for _ in range(steps):
                s = model.step(s)
            torch.cuda.synchronize()
        total = sum(t for t, _ in device_times(prof).values()) / 1e6
        busy = device_busy(td)
    rel = abs(busy["busy_s"] - total) / total
    print(f"[hws] trace of {steps} fused c48-L72 steps: device busy "
          f"{busy['busy_s'] * 1e3 / steps:.3f} ms/step from the Chrome "
          f"trace's interval union, {total * 1e3 / steps:.3f} ms/step from "
          f"the profiler's device events ({rel * 100:.3f}% apart), duty "
          f"{busy['duty']:.3f} over {busy['span_s'] * 1e3:.2f} ms ({card})")
    if rel > 0.02:
        fail(f"hws: trace union {busy['busy_s']} s vs device events {total} s")


def check_sampling_cost(torch, model, dev, card, steps=10):
    """Phase 12.4: the device-bound c192 preset, after 2 warm-up steps:
    5 steps without the sampler, 10 with a sample after each (the task's
    order: after the step's synchronisation, outside its time), 5 without;
    the sampled median may exceed the unsampled one by 2% at most."""
    from geosongpu_tpu_torch.hws.server import Sampler

    s = model.run(model.init(perturb=1e-3), 2)
    torch.cuda.synchronize()
    times = {False: [], True: []}
    with contextlib.closing(Sampler(rate_s=0.1, device=dev)) as sampler:
        for sampled in [False] * (steps // 2) + [True] * steps \
                + [False] * (steps - steps // 2):
            t0 = time.perf_counter()
            s = model.step(s)
            torch.cuda.synchronize()
            times[sampled].append(time.perf_counter() - t0)
            if sampled:
                sampler.sample_once()
    off, on = (statistics.median(times[k]) * 1e3 for k in (False, True))
    print(f"[hws] fused c192-L72, {steps} steps each: median {off:.2f} "
          f"ms/step without the sampler, {on:.2f} with "
          f"({(on / off - 1) * 100:+.2f}%; {card})")
    if on > 1.02 * off:
        fail(f"hws: sampling moved the c192 step {off:.2f} -> {on:.2f} ms")


def run_bridge(torch, np, build_model_for, preset, card):
    """Phase 13a: the bridge of interop/def_dycore.json generated into a
    temporary directory, the port's DycoreHook on the card, and
    interop/dycore_host.c compiled with gcc against the generated C source
    and libpython.  The host reads the initial state from Fortran-order
    files, calls bridge_init, init, BRIDGE_STEPS x run, validate_run on an
    equal and a changed copy of u, finalize, and writes the fields; they
    must equal BRIDGE_STEPS direct steps of the same model in this process
    bit for bit, and the host process's launches (the hook's hook.json)
    must be exactly PATHS' per step x BRIDGE_STEPS.  Prints the bridged and
    the direct ms per step, and the hook's own split of each run: the
    copies onto the card, the step, the copies back."""
    import re
    import tempfile

    from geosongpu_tpu_torch.cli import PRESETS
    from geosongpu_tpu_torch.core.state import state_to_numpy
    from geosongpu_tpu_torch.interop import dycore
    from geosongpu_tpu_torch.interop.generator import Bridge

    cfg = PRESETS[preset]
    dev = torch.device("cuda")
    model = build_model_for(preset)(cfg, dev)
    s = model.init(perturb=1e-3, seed=0)
    start = state_to_numpy(s)
    direct_ms = []
    for _ in range(BRIDGE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = model.step(s)
        torch.cuda.synchronize()
        direct_ms.append((time.perf_counter() - t0) * 1e3)
    want = state_to_numpy(s)
    ak, bk = model.ak, model.bk
    del model, s
    with tempfile.TemporaryDirectory(prefix="bridge_") as td:
        Bridge.from_file(os.path.join(os.path.dirname(dycore.__file__),
                                      "def_dycore.json")).write(td)
        dycore.write_hook(td, f'DycoreHook("{preset}", "cuda", HERE)')
        t0 = time.perf_counter()
        host = dycore.build_host(td)
        gcc_s = time.perf_counter() - t0
        data = os.path.join(td, "data")
        dycore.write_inputs(data, start, ak, bk)
        t0 = time.perf_counter()
        r = subprocess.run(
            [host, "run", td, data, str(cfg.npx), str(cfg.npz),
             str(cfg.ntracers), str(BRIDGE_STEPS), repr(cfg.dt),
             repr(cfg.ptop)], capture_output=True, text=True, cwd=td,
            env=dycore.host_env(td), timeout=600)
        host_s = time.perf_counter() - t0
        if r.returncode != 0 or "HOST_OK" not in r.stdout:
            fail(f"bridge host: rc {r.returncode}\n{r.stdout[-3000:]}\n"
                 f"{r.stderr[-5000:]}")
        bridged_ms = [float(m) for m in
                      re.findall(r"^run \d+: ([0-9.]+) ms$", r.stdout, re.M)]
        if len(bridged_ms) != BRIDGE_STEPS:
            fail(f"bridge host: {len(bridged_ms)} timed runs\n{r.stdout}")
        got = dycore.read_outputs(data, {k: v.shape
                                         for k, v in want.items()})
        with open(os.path.join(td, "hook.json")) as f:
            hook = json.load(f)
        launches = hook["launches"]
    for name in dycore.STATE_FIELDS:
        if not np.array_equal(got[name], want[name]):
            diff = np.abs(got[name].astype(np.float64) - want[name])
            fail(f"bridge: {name} differs from the direct steps by up to "
                 f"{float(np.nanmax(diff)):.3e} "
                 f"({int((got[name] != want[name]).sum())} elements)")
    check_launches_of("bridge host", launches, PATHS[preset][2],
                      BRIDGE_STEPS)
    tail = slice(1, None)     # the first run includes the library's load
    print(f"[bridge] {preset} c{cfg.npx}-L{cfg.npz} through the generated "
          f"C bridge (gcc {gcc_s:.2f} s; host process {host_s:.1f} s all "
          f"told): {BRIDGE_STEPS} runs "
          + ", ".join(f"{m:.2f}" for m in bridged_ms)
          + " ms wall, host<->card copies included; direct steps "
          + ", ".join(f"{m:.2f}" for m in direct_ms)
          + f" ms; mean of steps 2-{BRIDGE_STEPS}: bridged "
          f"{statistics.fmean(bridged_ms[tail]):.2f}, direct "
          f"{statistics.fmean(direct_ms[tail]):.2f} ms/step; the 14 state "
          f"fields equal bit for bit; validate_run 0 on an equal and 1 on "
          f"a changed copy of u; launches in the host "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f" ({card})")
    print("[bridge] the hook's split of each run, ms: " + "; ".join(
        f"{part} " + ", ".join(f"{m:.2f}" for m in ms)
        for part, ms in hook["ms"].items()) + f" ({card})")


def run_checkpoint(torch, np, counters, build_model_for, preset, card):
    """Phase 13b: path A, 4 steps straight; path B, 2 steps, save, restore
    onto the card into a freshly built model, 2 steps.  Every field equal
    bit for bit, each path's launches exactly PATHS' per step x 4 (counts
    set to 0 just before each path and read just after).  Prints the
    checkpoint's bytes and the save and restore seconds."""
    import tempfile

    from geosongpu_tpu_torch.cli import PRESETS
    from geosongpu_tpu_torch.core.state import state_to_numpy
    from geosongpu_tpu_torch.harness import checkpoint

    cfg = PRESETS[preset]
    dev = torch.device("cuda")
    model = build_model_for(preset)(cfg, dev)
    s0 = model.init(perturb=1e-3, seed=0)
    per_step = PATHS[preset][2]

    def reset():
        for fn in counters.values():
            fn.launches = 0

    reset()
    straight = state_to_numpy(model.run(s0, 4))
    torch.cuda.synchronize()
    check_launches_of("checkpoint path A", {k: fn.launches for k, fn in
                                            counters.items()}, per_step, 4)
    with tempfile.TemporaryDirectory(prefix="ckpt_") as td:
        reset()
        s2 = model.run(s0, 2)
        t0 = time.perf_counter()
        path = checkpoint.save(td, s2, cfg, step=2)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(td) for f in fs)
        del model, s2
        fresh = build_model_for(preset)(cfg, dev)
        t0 = time.perf_counter()
        restored, step = checkpoint.restore(td, dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        resumed = state_to_numpy(fresh.run(restored, 2))
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
    check_launches_of("checkpoint path B", launches, per_step, 4)
    if step != 2 or os.path.basename(path) != "ckpt_00000002":
        fail(f"checkpoint: restored step {step} from {path}")
    for name, a in straight.items():
        if not np.array_equal(resumed[name], a):
            fail(f"checkpoint: {name} after save, restore and 2 steps is "
                 f"not the straight run's ({int((resumed[name] != a).sum())}"
                 f" elements differ)")
    print(f"[checkpoint] {preset} c{cfg.npx}-L{cfg.npz}: 2 steps, save, "
          f"restore into a fresh model, 2 steps equal 4 straight steps bit "
          f"for bit (all 14 fields, mfx and mfy included); checkpoint "
          f"{nbytes} bytes, save {save_s:.3f} s, restore {restore_s:.3f} s "
          f"onto the card; launches of each path "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f" ({card})")


def run_harness_jobs(torch, np, card, name):
    """Phase 13c: ci-heartbeat, ci-clean (on a workspace with a stale file)
    and ci-info on cuda through the port's dispatch, whose ci_info.devices
    must name the card; a LocalBackend job from GPUJobConfig.one_gpu() with
    hardware_sampling around `cli run` of BRIDGE_PRESET on the card, which must
    end COMPLETED with a dump of samples with power > 0 and the card's
    UUID; and a job whose payload exits 1, which must end FAILED."""
    import tempfile

    from geosongpu_tpu_torch.harness.jobqueue import (JobState, LocalBackend,
                                                      wait_for_job)
    from geosongpu_tpu_torch.harness.launcher import GPUJobConfig
    from geosongpu_tpu_torch.harness.task import dispatch
    from geosongpu_tpu_torch.hws.analysis import load_data

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="jobs_") as td:
        ws, art = os.path.join(td, "ws"), os.path.join(td, "art")
        kw = dict(artifact_directory=art, workspace=ws, device="cuda")
        dispatch("ci-heartbeat", "All", **kw)
        if not os.path.isfile(os.path.join(art, "ci_metadata")):
            fail("ci-heartbeat: no ci_metadata in the artifact directory")
        with open(os.path.join(ws, "stale"), "w") as f:
            f.write("x")
        dispatch("ci-clean", "All", **kw)
        if os.listdir(ws) != ["ci_metadata"]:
            fail(f"ci-clean left {os.listdir(ws)}")
        devices = dispatch("ci-info", "All", **kw).get("ci_info.devices")
        if name not in devices:
            fail(f"ci-info: {devices!r} does not name the card {name!r}")

        uuid = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.split()[0]
        be = LocalBackend(td)
        job = GPUJobConfig(hosts=1, gpus_per_host=1,
                           env={"PYTHONPATH": root}, hardware_sampling=True)
        script = job.wrapper_script(
            [f"python -m geosongpu_tpu_torch.cli run --preset "
             f"{BRIDGE_PRESET} --steps 10 --device cuda"], name="hs_run",
            wd=td)
        t0 = time.perf_counter()
        h = be.submit([f"bash {script.path}"], "hs_job")
        state = wait_for_job(be, h, poll_s=0.5, timeout_s=400)
        job_s = time.perf_counter() - t0
        with open(os.path.join(td, "hs_job.log")) as f:
            log = f.read()
        if state != JobState.COMPLETED:
            fail(f"the sampled job ended {state}:\n{log[-4000:]}")
        d = load_data(os.path.join(td, "hws_dump.npz"))
        n = len(d["t_s"])
        power = float(np.max(d["tpu_psu"])) if n else 0.0
        if n < 1 or not power > 0.0 or str(d["gpu_uuid"]) != uuid:
            fail(f"the sampled job's dump: {n} samples, max power {power} W,"
                 f" uuid {d['gpu_uuid']} (card {uuid})")
        line = [x for x in log.splitlines() if "ms/step" in x]

        fail_job = GPUJobConfig.one_gpu().wrapper_script(
            ["python -c 'import sys; sys.exit(1)'"], name="bad_run", wd=td)
        h = be.submit([f"bash {fail_job.path}"], "bad_job")
        bad = wait_for_job(be, h, poll_s=0.2, timeout_s=120)
        if bad != JobState.FAILED:
            fail(f"the job whose payload exits 1 ended {bad}")
    print(f"[jobs] ci-heartbeat, ci-clean and ci-info through dispatch "
          f"passed; ci_info.devices {devices!r}")
    print(f"[jobs] LocalBackend, GPUJobConfig.one_gpu() with the sampler: "
          f"`cli run --preset {BRIDGE_PRESET} --steps 10` {state} in "
          f"{job_s:.1f} s; {line[-1].strip() if line else 'no step line'}; "
          f"dump of {n} samples, max power {power:.2f} W, mean "
          f"{float(np.mean(d['tpu_psu'])):.2f} W, uuid {uuid}; the job "
          f"exiting 1 ended {bad} ({card})")


def run_phase_13(torch, np, counters, build_model_for, card, name):
    """Phase 13: the host bridge, checkpoint and resume, the jobs."""
    run_bridge(torch, np, build_model_for, BRIDGE_PRESET, card)
    torch.cuda.empty_cache()
    run_checkpoint(torch, np, counters, build_model_for, BRIDGE_PRESET, card)
    torch.cuda.empty_cache()
    run_harness_jobs(torch, np, card, name)


def flow_state(model):
    """The JW06 analytic state (35 m/s jets, their balanced temperature)
    on the model's grid and levels, over the model's flat terrain: a
    developed flow, where a wrong exchange moves the winds by far more
    than the gates allow."""
    import dataclasses as dc

    from geosongpu_tpu_torch.models.baroclinic_wave import jw_initial_state

    s, _ = jw_initial_state(model.config, model.grid, model.ak, model.bk,
                            model.device)
    return dc.replace(s, phis=model.init(perturb=0.0).phis)


def sharded_vs_single(torch, np, model, mesh, label, counters, per_step,
                      card, rest_reference=None):
    """Phase 14: one step of `model` on all ranks of `mesh` stacked on the
    card against the single-device step, from two starts.  From the JW06
    flow, against the model's own single-device step: FLOW_FIELDS within
    FLOW_GATE of max|single|, no floor; every count set to 0 just
    before this sharded step and read just after, exact against per_step.
    From the perturbed rest start, against `rest_reference`'s step
    (another model's, default the model's own): SHARDED_FIELDS within
    SHARDED_GATE of max|single|, winds within SLICE_WIND_ATOL.  Returns
    (launches, (place, step), single ms/step, stacked ms/step), the times
    from the flow."""
    from geosongpu_tpu_torch.core.config import MeshConfig
    from geosongpu_tpu_torch.parallel.subtile import build_mesh_stepper

    place, step, unplace, desc = build_mesh_stepper(
        model, MeshConfig(**mesh), stacked=True)

    def compare(start, got, want, fields, rel, floor):
        diffs = []
        for f in fields:
            g, w = getattr(got, f), getattr(want, f)
            if not bool(g.isfinite().all()):
                fail(f"{label}: non-finite {f} from the {start}")
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            limit = max(rel * scale, floor if f in ("u", "v") else 0.0)
            if not err <= limit:
                fail(f"{label}: {f} {err:.3e} from the single-device step "
                     f"from the {start} > {limit:.3e}")
            diffs.append(f"{f} {err:.3e} ({err / max(scale, 1e-30):.2e} of "
                         f"max|single|)")
        return ", ".join(diffs)

    s0 = flow_state(model)
    want = model.step(s0)
    placed = place(s0)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = step(placed)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check_launches_of(label, launches, per_step, 1)
    got = unplace(out)
    flow = compare("flow", got, want, FLOW_FIELDS, FLOW_GATE, 0.0)
    omga = float((got.omga - want.omga).abs().max())
    rest0 = model.init(perturb=1e-3)
    rest = compare("rest start", unplace(step(place(rest0))),
                   (rest_reference or model).step(rest0), SHARDED_FIELDS,
                   SHARDED_GATE, SLICE_WIND_ATOL)
    ms = []
    for fn, arg in ((model.step, s0), (step, placed)):
        fn(arg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SHARDED_REPS):
            fn(arg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / SHARDED_REPS * 1e3)
    print(f"[sharded] {label}: {desc}; one step against single-device: "
          f"from the JW06 flow (max|u| {float(want.u.abs().max()):.2f} m/s) "
          f"max diff {flow}, omga {omga:.3e} (not gated); from the rest "
          f"start max diff {rest}; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; single-device {ms[0]:.2f} ms/step, all ranks stacked on the "
          f"one card {ms[1]:.2f} ms/step (not scaling; mean of "
          f"{SHARDED_REPS}; {card})")
    return launches, (place, step), ms[0], ms[1]


class Placed:
    """A sharded stepper with the model interface profile_steps uses:
    init places the model's initial state, step and run the sharded
    step."""

    def __init__(self, model, place, step):
        self.model, self.place, self._step = model, place, step
        self.config, self.device = model.config, model.device

    def init(self, perturb):
        return self.place(self.model.init(perturb=perturb))

    def step(self, s):
        return self._step(s)

    def run(self, s, steps):
        for _ in range(steps):
            s = self._step(s)
        return s


def locate_difference(torch, np, model, card):
    """Phase 14a: the (2, 4) step's parts against their single-device
    counterparts, from the JW06 flow: the dynamics alone (with the
    shared-edge symmetrization), printed; and the forcing alone on the
    block-local latitudes the step hands its forcing, which must equal the
    single-device forcing within FORCING_ULP ulp of the field's largest
    value (it is pointwise in the columns; the step gates cannot see a
    latitude mix-up, since one step of relaxation moves pt by millikelvin,
    ~100 such ulp)."""
    import dataclasses as dc

    from geosongpu_tpu_torch.parallel.halo import symmetrize_shared_edges
    from geosongpu_tpu_torch.parallel.subtile import (SubtileLayout,
                                                      build_subtile_step)

    cfg = model.config
    lay = SubtileLayout(n=cfg.npx, h=cfg.halo, py=2, px=4,
                        face_sharded=False)
    s0 = flow_state(model)
    seen = []

    def record(s, lats_l):
        seen.append(lats_l)
        return s

    step, place, unplace = build_subtile_step(model.ctx, lay,
                                              lats=model.lats, forcing=record)
    got = unplace(step(place(s0)))
    want = model.dynamics(s0)
    u, v = symmetrize_shared_edges(want.u, want.v)
    want = dc.replace(want, u=u, v=v)
    parts = [("dynamics", got, want, ("u", "v", "delp", "pt", "omga", "mfx",
                                     "mfy"))]
    # the latitudes the step hands its blocks
    forced = unplace(model.forcing(place(want), seen[0]))
    single = model.forcing(want)
    parts.append(("forcing", forced, single, ("u", "v", "pt")))
    ulps = {}
    for f in ("u", "v", "pt"):
        a = getattr(forced, f).cpu().numpy()
        b = getattr(single, f).cpu().numpy()
        ulps[f] = float(np.abs(a.astype(np.float64) - b).max()
                        / np.spacing(np.abs(b).max()))
        if not ulps[f] <= FORCING_ULP:
            fail(f"c{cfg.npx} (2,4): the forcing on the block latitudes is "
                 f"{ulps[f]:.0f} ulp from the single-device forcing in {f}")
    for label, g, w, fields in parts:
        print(f"[sharded] c{cfg.npx} (2,4), {label} alone against "
              "single-device: max diff " + ", ".join(
                  f"{f} {float((getattr(g, f) - getattr(w, f)).abs().max()):.3e}"
                  for f in fields) + f" ({card})")
    print(f"[sharded] c{cfg.npx} (2,4), the forcing on the block latitudes: "
          + ", ".join(f"{f} {u:.0f} ulp" for f, u in ulps.items())
          + f" from single-device ({card})")


def run_sharded(torch, np, counters, build_model_for, card, results, dev):
    """Phase 14, the sharded step on stacked ranks on `dev`.  Returns the
    launches of the (2, 4) fused path."""
    from dataclasses import replace

    from geosongpu_tpu_torch.cli import PRESETS
    from geosongpu_tpu_torch.harness.task import dispatch
    from geosongpu_tpu_torch.ops.kernels import dsw
    from geosongpu_tpu_torch.ops.kernels import remap as kremap
    from geosongpu_tpu_torch.ops.remap import remap_fields_banded

    t0 = time.perf_counter()
    fused = PRESETS[SHARDED_PRESET]
    model = build_model_for(SHARDED_PRESET)(fused, dev)
    per_step = PATHS[SHARDED_PRESET][2]
    # a. faces-local (2, 4): 8 ranks, 24 x 12 blocks, 48 slots
    launches, stepper, _, _ = sharded_vs_single(
        torch, np, model, dict(face=1, y=2, x=4), "c48 fused (2,4)",
        counters, per_step, card)
    # device time of each stage on the blocks, beside the faces', in turns
    profile_steps(torch, model, "c48 fused, one device", card)
    profile_steps(torch, Placed(model, *stepper), "c48 fused (2,4) stacked",
                  card)
    args = kernel_inputs(torch, np, model, dev, sharded=stepper)
    check_kernels(torch, dsw, args, list(args), "blocks", card, results)
    F, ny, nx = 48, fused.npx // 2, fused.npx // 4   # 48 x 24 x 12
    if tuple(args["dsw_csw1"][0].shape[:3]) != (F, ny + 1 + 6, nx + 6):
        fail(f"the (2,4) blocks are not {F} slots of {ny} x {nx}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results["remap_banded blocks"] = check_remap(
        torch, kremap, remap_fields_banded, fused, f"48 (2,4) blocks", gen,
        dev, card, 20, block=(F, ny, nx))
    del args, stepper
    # where a difference from the single-device step arises: the same
    # layout without the chart corrections, and the step's two parts apart
    sharded_vs_single(
        torch, np, build_model_for(SHARDED_PRESET)(
            replace(fused, chart_corners=False), dev),
        dict(face=1, y=2, x=4), "c48 fused (2,4) without chart corners",
        counters, per_step, card)
    locate_difference(torch, np, model, card)
    # b. face-sharded (6, 2, 2): 24 ranks, the 6*NX*NY rank shape
    sharded_vs_single(torch, np, model, dict(face=6, y=2, x=2),
                      "c48 fused (6,2,2)", counters, per_step, card)
    # d. eager with overlap_fills and rim_split on (2, 4): from the flow
    # against the single-device step with them (the pipelined pads move
    # the winds by ~3e-5 of max|u|, in the reference too), from the rest
    # start against the single-device eager step without them
    eager = PRESETS["held_suarez_c48_l72"]
    plain = build_model_for("held_suarez_c48_l72")(eager, dev)
    split = build_model_for("held_suarez_c48_l72")(
        replace(eager, overlap_fills=True, rim_split=True), dev)
    sharded_vs_single(torch, np, split, dict(face=1, y=2, x=4),
                      "c48 eager overlap_fills+rim_split (2,4)", counters,
                      PATHS["held_suarez_c48_l72"][2], card,
                      rest_reference=plain)
    del model, plain, split
    torch.cuda.empty_cache()
    # c. c192 fused on the held_suarez_c192 experiment's (6, 1, 1)
    c192 = build_model_for("held_suarez_c192_l72_fused")(
        PRESETS["held_suarez_c192_l72_fused"], dev)
    sharded_vs_single(torch, np, c192, dict(face=6, y=1, x=1),
                      "c192 fused blend (6,1,1)", counters,
                      PATHS["held_suarez_c192_l72_fused"][2], card)
    del c192
    torch.cuda.empty_cache()
    # e. through dispatch: the sharded experiment on 8 stacked ranks, and
    # the scaling task on the one card's one real rank
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        env = dispatch(SHARDED_EXPERIMENT, "Validation",
                       artifact_directory=os.path.join(tmp, "art"),
                       workspace=os.path.join(tmp, "ws"), device=dev.type,
                       stacked_ranks=True)
        rec = env.get("hs.record")
        if rec.extra["mesh"] != "subtile faces-local (2,4), 8 devices":
            fail(f"{SHARDED_EXPERIMENT}: mesh {rec.extra['mesh']!r}")
        print(f"[sharded] {SHARDED_EXPERIMENT} Validation through dispatch: "
              f"{rec.extra['mesh']}; gates passed; median step "
              f"{statistics.median(rec.step_time_s) * 1e3:.2f} ms (8 ranks "
              f"stacked on one card; {card})")
        env = dispatch("scaling_bench", "All",
                       artifact_directory=os.path.join(tmp, "art"),
                       workspace=os.path.join(tmp, "ws"), device=dev.type)
        res = env.get("scaling.results")
        c = res["comm"]
        print(f"[sharded] scaling_bench: {res['n_devices']} real rank; "
              + ", ".join(f"c{e['npx']} {e['step_s'] * 1e3:.2f} ms/step"
                          for e in res["weak_scaling"])
              + "; loopback ring copy "
              + ", ".join(f"{sz} B {g:.2f} GB/s"
                          for sz, g in zip(c["sizes"], c["ppermute_gbps"]))
              + f"; sum {statistics.median(c['psum_us']):.1f} us ({card})")
    print(f"[sharded] phase 14: {time.perf_counter() - t0:.1f} s")
    return launches


def validate_card_against_cpu(torch, np, dev, tmp):
    """Phase 15a: phase 9's fused case, card and CPU written as .npz and
    compared through the port's validation CLI: delp, pt and ps within
    TOOLS_REL_TOL relative RMS (exit code 0), ua and va printed only (the
    winds are held to an absolute floor, SLICE_WIND_ATOL); then
    check_tolerance on pt + 0.5 K must fail."""
    from geosongpu_tpu_torch.validation import cli as vcli
    from geosongpu_tpu_torch.validation.analysis import (check_tolerance,
                                                         load_dataset)

    cpu, card_state = card_vs_cpu(torch, np, "held_suarez_c48_l72_fused", dev,
                                  "fused (for validation)")
    paths = {}
    for label, st in (("cpu", cpu), ("card", card_state)):
        paths[label] = os.path.join(tmp, f"{label}.npz")
        np.savez(paths[label], **st)
    for var in TOOLS_GATED + TOOLS_PRINTED:
        print(f"[tools] validate CPU {var} against the card's: ", end="",
              flush=True)
        argv = ["validate", paths["cpu"], paths["card"], var]
        if var in TOOLS_GATED:
            argv += ["--rel_tol", str(TOOLS_REL_TOL)]
        if vcli.main(argv) != 0:
            fail(f"geosongpu-tpu-torch-validation validate {var}: the card "
                 f"is above {TOOLS_REL_TOL} relative RMS from the CPU")
    ref, comp = load_dataset(paths["cpu"]), load_dataset(paths["card"])
    if check_tolerance(ref, {**comp, "pt": comp["pt"] + 0.5}, ["pt"],
                       rel_tol=TOOLS_REL_TOL):
        fail("check_tolerance passed pt + 0.5 K")
    print("[tools] check_tolerance refuses the card's pt + 0.5 K")


def serialbox_blocks(torch, np, build_model_for, dev, tmp):
    """Phase 15b: one fused c48-L72 step on the faces-local (2, 4) layout's
    stacked ranks, each slot's centred fields written with write_fixture
    as the Serialbox rank of its face and block, converted back through
    the validation CLI; the result must equal the step's unplaced global
    fields bit for bit."""
    from geosongpu_tpu_torch.cli import PRESETS
    from geosongpu_tpu_torch.core.config import MeshConfig
    from geosongpu_tpu_torch.core.state import state_to_numpy
    from geosongpu_tpu_torch.parallel.subtile import (build_mesh_stepper,
                                                      layout_from_mesh)
    from geosongpu_tpu_torch.validation import cli as vcli
    from geosongpu_tpu_torch.validation import serialbox_python
    from geosongpu_tpu_torch.validation.serialbox_binary import write_fixture

    cfg = PRESETS[SHARDED_PRESET]
    model = build_model_for(SHARDED_PRESET)(cfg, dev)
    mesh = MeshConfig(face=1, y=2, x=4)
    lay = layout_from_mesh(mesh, cfg.npx, cfg.halo)
    place, step, unplace, desc = build_mesh_stepper(model, mesh, stacked=True)
    out = step(place(flow_state(model)))
    blocks = {f: getattr(out, f).cpu().numpy() for f in SERIALBOX_FIELDS}
    want = state_to_numpy(unplace(out))
    dat, conv = os.path.join(tmp, "dat"), os.path.join(tmp, "converted")
    # slot d * 6 + face of the stacked blocks -> the converter's rank
    # face * px * py + by * px + bx
    for d in range(lay.ndevices):
        _, by, bx = lay.dev_coords(d)
        for face in range(lay.nslots):
            rank = face * lay.px * lay.py + by * lay.px + bx
            write_fixture(dat, f"Generator_rank{rank}", ["HeldSuarez-Out"],
                          {f: [blocks[f][d * lay.nslots + face]]
                           for f in SERIALBOX_FIELDS})
    # the card's machine has no serialbox: the port's reader of its binary
    # layout stands in for it (validation/serialbox_python)
    before = os.environ.get("SERIALBOX_PYTHON")
    os.environ["SERIALBOX_PYTHON"] = os.path.dirname(serialbox_python.__file__)
    try:
        rc = vcli.main(["serialbox", dat, conv, "-l", f"{lay.px},{lay.py}",
                        "-f", "npz"])
    finally:
        if before is None:
            del os.environ["SERIALBOX_PYTHON"]
        else:
            os.environ["SERIALBOX_PYTHON"] = before
    if rc != 0:
        fail("geosongpu-tpu-torch-validation serialbox failed")
    got = np.load(os.path.join(conv, "HeldSuarez-Out.npz"))
    diffs = {}
    for f in SERIALBOX_FIELDS:
        if got[f].shape != want[f].shape or got[f].dtype != want[f].dtype:
            fail(f"serialbox {f}: {got[f].shape} {got[f].dtype}, the step's "
                 f"{want[f].shape} {want[f].dtype}")
        diffs[f] = float(np.abs(got[f].astype(np.float64) - want[f]).max())
        if diffs[f] != 0.0:
            fail(f"serialbox {f}: {diffs[f]:.3e} from the step's global field")
    print(f"[tools] {desc}: {lay.ndevices * lay.nslots} slots of "
          f"{lay.bny} x {lay.bnx} written as Serialbox ranks and converted "
          f"(layout {lay.px},{lay.py}): max diff from the unplaced step "
          + ", ".join(f"{f} {d}" for f, d in diffs.items()))


def step_bytes(torch, np, model, dev):
    """Phase 3/4's bytes a step of the fused c48-L72 path moves: each
    substep kernel's bound bytes on kernel_inputs times its launches a
    step, and remap_banded's over the step's three calls."""
    from geosongpu_tpu_torch.ops.kernels import dsw

    per_step = PATHS[SHARDED_PRESET][2]
    args = kernel_inputs(torch, np, model, dev)
    out = {}
    for name, n in per_step.items():
        if name == "remap_banded":
            continue
        got = getattr(dsw, name)(*args[name])
        out[name] = n * moved_bytes(tensors_of(args[name],
                                               METRICS_READ[name]), got)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out["remap_banded"] = sum(
        moved_bytes(qs + [pe1, pe2], qs)
        for _, qs, pe1, pe2 in remap_calls(torch, model.config,
                                           model.config.npx, gen, dev))
    return out


def print_roofline(label, art, want, card):
    """The roofline twin's artifact, a kernel a line; want: phase 3/4's
    bytes a step by kernel, printed beside the twin's."""
    print(f"[tools] roofline of {label}, {art['config']['steps']} steps: "
          f"wall {art['wall_ms_per_step']:.2f} ms/step (with the recorder), "
          f"device busy {art['device_busy_ms_per_step']:.3f} ms/step, the "
          f"kernels {art['kernels_device_ms_per_step']:.3f} ({card})")
    for name, k in art["kernels"].items():
        n = k["launches_per_step"]
        print(f"[tools]   {name}: {n:g} launches/step, "
              f"{k['gbytes_per_step'] * 1e3:.3f} MB/step"
              + (f" (phase 3/4: {want[name] / 1e6:.3f})" if name in want
                 else "")
              + f", device {k['device_ms_per_step']:.4f} ms/step = "
              f"{k['device_ms_per_step'] / n:.4f} a launch, "
              f"{k['achieved_gb_s']:.1f} GB/s = "
              f"{100 * k['share_of_hbm']:.1f}% of 3.35 TB/s; bound "
              f"{k['bound_ms_per_step'] / n:.4f} ms a launch by "
              f"{k['bound_by']}")


def run_tool_scripts(torch, np, build_model_for, card, dev):
    """Phase 15c: the tool scripts' twins on the card: the ladder's two
    rungs (finite), the phase profile and the roofline of the fused
    c48-L72 preset (its bytes a step within TOOLS_BYTES_TOL of phase 3/4's,
    its kernels inside the trace's busy time) and the climatology at
    c12-L20 (finite (32, 20) means)."""
    from geosongpu_tpu_torch.cli import PRESETS
    from geosongpu_tpu_torch.core.config import DycoreConfig, MeshConfig
    from geosongpu_tpu_torch.models.held_suarez import build_model
    from geosongpu_tpu_torch.parallel.subtile import build_mesh_stepper
    from geosongpu_tpu_torch.scripts import (bench_ladder, hs_climatology,
                                             phase_profile, roofline)

    for npx in (48, 192):
        e = bench_ladder.run_rung(npx, 72, TOOLS_LADDER_STEPS, dev)
        print(f"[tools] bench_ladder {json.dumps(e)}")
        if not e["finite"]:
            fail(f"bench_ladder c{npx}: {e['error']}")
    torch.cuda.empty_cache()
    phases = phase_profile.profile(SHARDED_PRESET, device="cuda")
    print(f"[tools] phase_profile {json.dumps(phases)}")
    model = build_model_for(SHARDED_PRESET)(PRESETS[SHARDED_PRESET], dev)
    art = roofline.roofline(model, model.run(model.init(perturb=1e-3), 3),
                            TOOLS_ROOFLINE_STEPS)
    want = step_bytes(torch, np, model, dev)
    print_roofline(SHARDED_PRESET, art, want, card)
    for name, b in want.items():
        got = art["kernels"].get(name, {}).get("gbytes_per_step", 0.0) * 1e9
        if not abs(got - b) <= TOOLS_BYTES_TOL * b:
            fail(f"roofline {name}: {got:.0f} bytes a step, phase 3/4 {b:.0f}")
    if not (art["kernels_device_ms_per_step"]
            <= art["device_busy_ms_per_step"]):
        fail("roofline: the kernels' device time exceeds the trace's busy "
             "time")
    # the same on the faces-local (2, 4) blocks (PERF.md rows "s")
    place, step, _, desc = build_mesh_stepper(
        model, MeshConfig(face=1, y=2, x=4), stacked=True)
    stacked = Placed(model, place, step)
    print_roofline(f"{SHARDED_PRESET} on {desc} stacked", roofline.roofline(
        stacked, stacked.run(stacked.init(perturb=1e-3), 3),
        TOOLS_ROOFLINE_STEPS), {}, card)
    del model, stacked, place, step
    torch.cuda.empty_cache()
    clim = build_model(DycoreConfig(npx=12, npz=20, dt=900.0, n_split=6),
                       dev)
    ubar, tbar, edges, nsamp = hs_climatology.climatology(
        clim, clim.init(perturb=0.1), days=2.0, spinup=1.0)
    for name, a in (("ubar", ubar), ("tbar", tbar)):
        if a.shape != (hs_climatology.NBINS, 20) or not np.isfinite(a).all():
            fail(f"climatology {name}: shape {a.shape} or not finite")
    jet, trop = hs_climatology.jet_and_tropics(ubar, edges)
    print(f"[tools] hs_climatology c12-L20, 1 + 1 days, {nsamp} samples: "
          f"ubar, tbar (32, 20) finite; jet {jet:.2f} m/s, tropical surface "
          f"u {trop:.2f} m/s (not gated) ({card})")


def run_tools(torch, np, build_model_for, card, dev):
    """Phase 15, the tools on the card's output."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        validate_card_against_cpu(torch, np, dev, tmp)
        serialbox_blocks(torch, np, build_model_for, dev, tmp)
    torch.cuda.empty_cache()
    run_tool_scripts(torch, np, build_model_for, card, dev)
    print(f"[tools] phase 15: {time.perf_counter() - t0:.1f} s ({card})")


T_START = time.perf_counter()


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
        from geosongpu_tpu_torch.hws.nvml import NVML
        from geosongpu_tpu_torch.hws.server import Sampler
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
    # NVML's view of the card, and its idle power before any work is queued
    with NVML() as nvml:
        driver = nvml.driver_version()
    with contextlib.closing(Sampler(rate_s=0.2, device=dev)) as sampler:
        limit_w = sampler.gpu.power_limit_w
        idle_w, idle_busy = sample_idle(sampler)
    smi_w = float(card.rsplit(",", 1)[1].split()[0])
    print(f"[device] NVML: version {driver}, power limit {limit_w:.2f} W "
          f"(nvidia-smi {smi_w:.2f} W); idle {idle_w:.2f} W, busy "
          f"{idle_busy:.3f} (10 samples at 0.2 s)")
    if abs(limit_w - smi_w) > 0.005:
        fail(f"NVML's power limit {limit_w} W is not nvidia-smi's {smi_w} W")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"[build] {len(build.sources()[0])} sources: "
          f"{time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s)"
          f" -> {lib.path.parent.name}/{lib.path.name}")
    print_build_log(lib.build_log)
    if "--harness" in sys.argv[1:]:
        run_phase_13(torch, np, counters, build_model_for, card, name)
        return 0
    if "--sharded" in sys.argv[1:]:
        run_sharded(torch, np, counters, build_model_for, card, {}, dev)
        return 0
    if "--tools" in sys.argv[1:]:
        run_tools(torch, np, build_model_for, card, dev)
        return 0
    if "--stages" in sys.argv[1:]:
        if "solve" in sys.argv[1:]:
            pname = "held_suarez_c48_l72_nh_fused"
            form, _, steps = STAGE_KERNELS[pname]
            model = build_model_for(pname)(PRESETS[pname], dev)
            args = kernel_inputs(torch, np, model, dev, steps=steps)
            del model
            stage_times(torch, dsw, args, ["nh_vertical_solve"], form, card)
            del args
            solve_stage(torch, np, dsw, dev, card)
            return 0
        if "columns" not in sys.argv[1:]:
            for pname, (form, names, steps) in STAGE_KERNELS.items():
                model = build_model_for(pname)(PRESETS[pname], dev)
                args = kernel_inputs(torch, np, model, dev, steps=steps)
                del model
                stage_times(torch, dsw, args, names, form, card)
                del args
                torch.cuda.empty_cache()
            solve_stage(torch, np, dsw, dev, card)
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
    check_kernels(torch, dsw, args,
                  ["dsw_tracer", "dsw_nh_pert", "nh_vertical_solve"], "",
                  card, results)
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
    idle = {}
    for pname, (label, _, _) in PATHS.items():
        busy, events = profile_steps(torch, model_of(pname), label, card)
        idle[label] = (step_ms[label], busy, events,
                       1.0 - busy / step_ms[label])
    print("[main] ms/step (phase 7), device busy ms/step, device events/step"
          " and idle share: " + ", ".join(
              f"{label} {ms:.2f}, {b:.2f}, {e:.0f}, {100 * i:.1f}%"
              for label, (ms, b, e, i) in idle.items()) + f" ({card})")
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
    run_ci_pipelines(torch, counters, card, limit_w, idle_w)

    # ---- 12. the sampler and the trace reader on the card ---------------
    check_idle_and_busy(torch, dev, card)
    check_server(card, name)
    check_trace_union(torch, build_model_for("held_suarez_c48_l72_fused")(
        PRESETS["held_suarez_c48_l72_fused"], dev), card)
    torch.cuda.empty_cache()
    check_sampling_cost(torch, build_model_for("held_suarez_c192_l72_fused")(
        PRESETS["held_suarez_c192_l72_fused"], dev), dev, card)
    torch.cuda.empty_cache()

    # ---- 13. the host bridge, checkpoint and resume, jobs ----------------
    run_phase_13(torch, np, counters, build_model_for, card, name)

    # ---- 14. the sharded step on stacked ranks ---------------------------
    launches["blocks"] = run_sharded(torch, np, counters, build_model_for,
                                     card, results, dev)

    # ---- 15. the tools on the card's output -------------------------------
    run_tools(torch, np, build_model_for, card, dev)

    # each entry: (key of results, kernel, path whose launches it reports)
    entries = [(k, k, "fused") for k in list(KERNELS)[:6]] + [
        ("dsw_wind blend", "dsw_wind", "c192"),
        ("dsw_transport nh", "dsw_transport", "nh"),
        ("dsw_wind nh", "dsw_wind", "nh"),
        ("dsw_tracer", "dsw_tracer", "nh"),
        ("dsw_nh_pert", "dsw_nh_pert", "nh"),
        ("nh_vertical_solve", "nh_vertical_solve", "nh"),
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

    print(json.dumps({"kernels_blocks": rows(
        [(f"{k} blocks", k, "blocks")
         for k in list(KERNELS)[:6]])}))
    print(json.dumps({"kernels_c192": rows(
        [(f"{k} c192", k, "c192")
         for k in C192_KERNELS + ["remap_banded"]])}))
    print(f"[main] whole script: {time.perf_counter() - T_START:.1f} s "
          f"({card})")
    print(json.dumps({"kernels": rows(entries)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

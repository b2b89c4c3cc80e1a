#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, and exits non-zero
on any failure (and when no CUDA device is present).  Phases:

1. device: the card's name and power limit (nvidia-smi), the toolchain;
2. build: the one kernel library from the checkout's csrc/ sources, with
   ptxas registers and spills per kernel;
3. remap_banded against its plain PyTorch version at the three c48-L72
   main-path shapes (max error relative to the plain output <= 1e-5);
4. the substep kernels against their plain versions, over the whole padded
   outputs, on inputs from a real state (init + 2 steps, then the substep
   chain of plain versions): the five hydrostatic kernels at c48-L72; the
   nonhydrostatic forms (dsw_transport with w and delz, dsw_tracer,
   dsw_nh_pert, dsw_wind with the p', phi', rho terms) at c48-L72 on a
   nonhydrostatic state; the blend form of dsw_wind at c192-L72.
   dsw_csw1, dsw_transport, dsw_tracer and dsw_tracer_acc within 1e-5 of
   max|plain|; dsw_csw2, dsw_wind and dsw_nh_pert within max(1e-4
   max|plain|, 2e-3), for the column-sum order;
5. the four presets through build_model / init / step, each with every
   launch count set to 0 just before and read just after: the rest state
   stays at rest (nonhydrostatic: w and p' at rounding level), the steps
   stay finite, mass is conserved, and every kernel launches exactly as
   often as the path prescribes (per step, PATHS below);
6. a torch.profiler window of 2 steps of each preset: device busy time,
   device events per step and the top device kernels;
7. card against CPU: 3 steps at c12-L8 from one numpy state, the two c48
   hydrostatic presets, the nonhydrostatic preset and the blend form.

Phases 3 and 4 print the median time of 20 calls (10 at c192), kernel and
plain.  The second-to-last line is the kernels JSON object, the last line
{"ok": true, "device": {...}}.

Each kernel's bound in that object is the larger of two times computed
here from the call's shapes: every input read and every output written
once at 3.35 TB/s (of the 36 PaddedMetrics arrays only those the kernel's
stages read, METRICS_READ), and OPS_PER_POINT operations per output point
at the card's 67 TFLOP/s of float32 outside the tensor cores.  No single PyTorch
call computes any of these stencil and column functions, so library_ms is
null throughout.
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
}
# Arithmetic of the plain version per output point, each PPM edge counted
# once per cell (a ppm_flux ~33 operations with the hord-8 limiter, an
# fvtp2d ~150 per field, a corner interpolation ~15, a column integral ~60
# with pow and log as 20 each).  Every kernel comes out bound by its bytes.
OPS_PER_POINT = {
    "remap_banded": 250, "dsw_csw1": 80, "dsw_csw2": 170,
    "dsw_transport": 330, "dsw_transport nh": 650, "dsw_wind": 220,
    "dsw_wind blend": 280, "dsw_wind nh": 345, "dsw_tracer_acc": 170,
    "dsw_tracer": 165, "dsw_nh_pert": 70,
}
# The PaddedMetrics fields each kernel (and form) reads: the met(m, X, ...)
# uses of its source and of the csrc/dsw_common.cuh stages it launches
# (fvtp2d, hydro_columns, chart_resample, corner_w).  The bound counts these
# metric arrays and no other.  dsw_wind's rotational damping (VTX_METRICS)
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
}
# __global__ stages of csrc/*.cu, as the profiler names them
PORT_STAGES = ("::csw1(", "::csw2_", "::fv_inner(", "::fv_flux(",
               "::transport_update(", "::nh_transport_update(",
               "::tracer_update(", "::tracer_sub_update(", "::wind_update(",
               "::blend_divergence(", "::hydro_columns(", "::nh_columns(",
               "::remap_banded_kernel<")
# preset -> (label, steps timed after 3 warm-up steps, launches per step)
PATHS = {
    "held_suarez_c48_l72": ("eager", 10, {"remap_banded": 3}),
    "held_suarez_c48_l72_fused": ("fused", 10, {
        "dsw_csw1": 6, "dsw_csw2": 6, "dsw_transport": 6, "dsw_wind": 6,
        "dsw_tracer_acc": 2, "remap_banded": 3}),
    "held_suarez_c192_l72_fused": ("c192", 5, {       # n_split 8
        "dsw_csw1": 8, "dsw_csw2": 8, "dsw_transport": 8, "dsw_wind": 8,
        "dsw_tracer_acc": 2, "remap_banded": 3}),
    "held_suarez_c48_l72_nh_fused": ("nh", 10, {
        "dsw_csw1": 6, "dsw_csw2": 6, "dsw_transport": 6, "dsw_wind": 6,
        "dsw_tracer": 6, "dsw_nh_pert": 6, "remap_banded": 3}),
}


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
    (3 K of pt noise, a tracer 1 + 0.2 U[0,1)), `steps` steps, fill, then
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
    if cfg.z_tracer:
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
                   tensors_of(torch, a, METRICS_READ[key]), got)
        b_ms, b_by = max(by), ("bytes" if by[0] >= by[1] else "operations")
        results[key] = (err, k_ms, p_ms, b_ms, b_by)
        print(f"[kernel] {key} {tuple(got[0].shape)}: max abs err "
              f"{err:.3e}, max rel err {rel:.3e}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} (median of "
              f"{reps}; {card})")


def run_preset(torch, np, model, counters, label, card, steps, per_step):
    """Rest state, then 3 + `steps` steps with every count set to 0 just
    before and read just after, finiteness, peak memory, mass drift.
    Returns (ms/step, {kernel: launches})."""
    from geosongpu_tpu_torch.core.state import state_to_numpy
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

    s = model.init(perturb=1e-3)
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


def card_vs_cpu(torch, np, preset, dev, label, **changes):
    from geosongpu_tpu_torch.core.state import state_from_numpy, state_to_numpy
    from geosongpu_tpu_torch.models.held_suarez import build_model

    small = dataclasses.replace(preset, npx=12, npz=8, dt=1200.0, n_split=2,
                                **changes)
    m_cpu = build_model(small, torch.device("cpu"))
    m_gpu = build_model(small, dev)
    start = state_to_numpy(m_cpu.init(perturb=3.0))
    rng = np.random.default_rng(5)
    start["q"] = (1.0 + 0.2 * rng.random(start["q"].shape)).astype(np.float32)
    a = state_to_numpy(m_cpu.run(state_from_numpy(start, "cpu"), 3))
    b = state_to_numpy(m_gpu.run(state_from_numpy(start, dev), 3))
    diffs = {}
    fields = ("u", "v", "delp", "pt", "q", "ps")
    if not small.hydrostatic:
        fields += ("w", "delz")
    for f in fields:
        if a[f].shape != b[f].shape or not np.isfinite(b[f]).all():
            fail(f"{label} card vs CPU at c12-L8: {f} has shape "
                 f"{b[f].shape} on the card, {a[f].shape} on the CPU, or is "
                 "not finite")
        scale = float(np.abs(a[f]).max())
        d = float(np.abs(a[f] - b[f]).max())
        diffs[f] = d / scale
        atol = SLICE_WIND_ATOL if f in ("u", "v", "w") else 0.0
        if not d <= max(SLICE_GATE * scale, atol):
            fail(f"{label} card vs CPU at c12-L8: {f} differs by {d:.3e} "
                 f"(max {scale:.3e})")
    print(f"[cpu-vs-card] {label} c12-L8, 3 steps, max rel diff: "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))


def profile_steps(torch, model, label, card, steps=2):
    """Device time, device events and the top ops over `steps` steps, after
    one profiled step that absorbs the profiler's own start-up."""
    from torch.autograd import DeviceType
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
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    stats = {}
    for e in dev_events:
        t, c = stats.get(e.name, (0.0, 0))
        stats[e.name] = (t + e.device_time_total, c + 1)
    busy = sum(t for t, _ in stats.values()) / steps / 1e3
    ours = [(t, c) for n, (t, c) in stats.items()
            if any(s in n for s in PORT_STAGES)]
    print(f"[profile] {label}: wall {wall:.2f} ms/step under the profiler, "
          f"device busy {busy:.2f} ms/step, {len(dev_events) / steps:.0f} "
          f"device events/step; the port's kernels "
          f"{sum(t for t, _ in ours) / steps / 1e3:.2f} ms/step in "
          f"{sum(c for _, c in ours) / steps:.0f} launches/step ({card})")
    top = sorted(stats.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        print(f"[profile]   {t / steps / 1e3:8.3f} ms/step {c / steps:7.0f}"
              f"/step  {name[:90]}")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    try:
        from geosongpu_tpu_torch.cli import PRESETS
        from geosongpu_tpu_torch.models.held_suarez import build_model
        from geosongpu_tpu_torch.ops.kernels import build, dsw
        from geosongpu_tpu_torch.ops.kernels import remap as kremap
        from geosongpu_tpu_torch.ops.remap import remap_fields_banded
    except ImportError as e:
        fail(f"run from the root of a checkout (port not importable: {e})")
    dev = torch.device("cuda")
    counters = {"remap_banded": kremap.remap_banded,
                **{k.__name__: k for k in dsw.KERNELS}}

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
    results = {}   # kernel [form] -> (max_abs_err, ms, plain_ms, bound_ms, by)

    # ---- 3. remap_banded against its plain version ------------------------
    preset = PRESETS["held_suarez_c48_l72"]
    band, K, n = preset.remap_band, preset.npz, preset.npx
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = [("pt+q", (6, n, n), 2, 300.0), ("u", (6, n + 1, n), 1, 10.0),
              ("v", (6, n, n + 1), 1, 10.0)]
    max_abs_err, kernel_ms, plain_ms, by = 0.0, 0.0, 0.0, [0.0, 0.0]
    for label, lead, nf, scale in shapes:
        pe1, pe2 = displaced_coordinates(torch, lead, K, band, gen, dev)
        qs = [(scale * (1.0 + 0.1 * torch.randn(lead + (K,), generator=gen,
                                                device=dev))).contiguous()
              for _ in range(nf)]
        got = kremap.remap_banded(qs, pe1, pe2, preset.kord, band)
        want = remap_fields_banded(qs, pe1, pe2, preset.kord, band)
        torch.cuda.synchronize()
        err, rel = compare(f"remap_banded {label}", got, want, False)
        max_abs_err = max(max_abs_err, err)
        k_ms = median_ms(torch, lambda: kremap.remap_banded(
            qs, pe1, pe2, preset.kord, band))
        p_ms = median_ms(torch, lambda: remap_fields_banded(
            qs, pe1, pe2, preset.kord, band))
        kernel_ms += k_ms
        plain_ms += p_ms
        by = [x + y for x, y in zip(by, bound(
            "remap_banded", qs + [pe1, pe2], got,
            points=sum(t.numel() for t in got)))]
        print(f"[kernel] remap_banded {label} {nf}x{tuple(qs[0].shape)}: max "
              f"rel err {rel:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(median of 20; {card})")
    print(f"[kernel] remap_banded, one step's 3 calls: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{max(by):.4f} ms ({card})")
    results["remap_banded"] = (max_abs_err, kernel_ms, plain_ms, max(by),
                               "bytes" if by[0] >= by[1] else "operations")

    # ---- 4. the substep kernels against their plain versions ----------
    models = {}

    def model_of(name):
        if name not in models:
            models[name] = build_model(PRESETS[name], dev)
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
    del args, a
    torch.cuda.empty_cache()

    # ---- 5. the four main paths ------------------------------------------
    step_ms, launches = {}, {}
    for pname, (label, steps, per_step) in PATHS.items():
        step_ms[label], launches[label] = run_preset(
            torch, np, model_of(pname), counters, label, card, steps,
            per_step)
    print("[main] in one call: " + ", ".join(
        f"{label} {ms:.2f} ms/step" for label, ms in step_ms.items())
        + f" ({card})")

    # ---- 6. profiler window ---------------------------------------------
    for pname, (label, _, _) in PATHS.items():
        profile_steps(torch, model_of(pname), label, card)
    models.clear()
    torch.cuda.empty_cache()

    # ---- 7. card against CPU ----------------------------------------------
    fused_preset = PRESETS["held_suarez_c48_l72_fused"]
    card_vs_cpu(torch, np, preset, dev, "eager")
    card_vs_cpu(torch, np, fused_preset, dev, "fused")
    card_vs_cpu(torch, np, PRESETS["held_suarez_c48_l72_nh_fused"], dev, "nh")
    card_vs_cpu(torch, np, fused_preset, dev, "blend",
                damping_exchange="blend")

    # each entry: (key of results, kernel, path whose launches it reports)
    entries = [(k, k, "fused") for k in list(KERNELS)[:6]] + [
        ("dsw_wind blend", "dsw_wind", "c192"),
        ("dsw_transport nh", "dsw_transport", "nh"),
        ("dsw_wind nh", "dsw_wind", "nh"),
        ("dsw_tracer", "dsw_tracer", "nh"),
        ("dsw_nh_pert", "dsw_nh_pert", "nh")]
    print(json.dumps({"kernels": [{
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
    } for key, k, path in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
4. the five fused substep kernels against their plain versions at the
   c48-L72 shapes, on inputs from a real state (init + 2 eager steps,
   then the substep chain of plain versions), over the whole padded
   outputs: dsw_csw1, dsw_transport, dsw_tracer_acc within 1e-5 of
   max|plain|; dsw_csw2 and dsw_wind within max(1e-4 max|plain|, 2e-3
   m/s), for the column-sum order;
5. the eager preset held_suarez_c48_l72 through build_model / init /
   step: rest state stays at rest, 3 + 20 steps stay finite, mass is
   conserved, remap_banded launches 3 times per step;
6. the fused preset held_suarez_c48_l72_fused likewise, with exactly 6
   launches per step of each substep kernel, 2 of dsw_tracer_acc and 3 of
   remap_banded;
7. a torch.profiler window of 2 steps of each preset: device busy time,
   device events per step and the top device kernels;
8. card against CPU: 3 steps at c12-L8 from one numpy state, both presets.

Phases 3 and 4 print the median time of 20 calls, kernel and plain.  The
second-to-last line is the kernels JSON object, the last line
{"ok": true, "device": {...}}.
"""
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time

REL_GATE = 1e-5          # kernel vs plain, relative to max |plain|
COLUMN_GATE = 1e-4       # dsw_csw2 / dsw_wind: relative, with a wind floor
COLUMN_WIND_ATOL = 2e-3  # m/s
SLICE_GATE = 1e-4        # card vs CPU after 3 steps (whole-slice gate)
SLICE_WIND_ATOL = 6e-3   # m/s
STEPS = 20

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
}
# __global__ stages of csrc/*.cu, as the profiler names them
PORT_STAGES = ("::csw1(", "::csw2_", "::fv_inner(", "::fv_flux(",
               "::transport_update(", "::tracer_update(", "::wind_update(",
               "::hydro_columns(", "::remap_banded_kernel<")
FUSED_PER_STEP = {"dsw_csw1": 6, "dsw_csw2": 6, "dsw_transport": 6,
                  "dsw_wind": 6, "dsw_tracer_acc": 2, "remap_banded": 3}


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


def kernel_inputs(torch, np, model, dev):
    """{kernel name: args} at the model's shapes from a real state: init
    (3 K of pt noise, a tracer 1 + 0.2 U[0,1)), 2 eager steps, fill, then
    one substep of plain versions; dsw_tracer_acc takes the substep's
    winds and mass fluxes accumulated over n_split substeps and split in
    q_split subcycles."""
    from geosongpu_tpu_torch.dycore.sw import fill_substep
    from geosongpu_tpu_torch.dycore.sw_fused import substep_kernel_args

    cfg, ctx = model.config, model.ctx
    st = model.init(perturb=3.0)
    rng = np.random.default_rng(5)
    st.q = torch.as_tensor((1.0 + 0.2 * rng.random(tuple(st.q.shape)))
                           .astype(np.float32), device=dev)
    st = model.run(st, 2)
    dt = cfg.dt / (cfg.k_split * cfg.n_split)
    s = fill_substep(ctx.ops, st.u, st.v, st.delp, st.pt, chart=ctx.chart)
    args, out = substep_kernel_args(
        s, ctx.metrics, ctx.ops, dt, cfg.ptop, hord=cfg.hord,
        d2_bg=cfg.d2_bg, hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm,
        chart=ctx.chart, stag_tabs=ctx.stag, vtx_damp=cfg.vtx_damp)
    qx = ctx.chart.apply_scalar(ctx.ops.fill(st.q[..., 0], "x"), "x")
    r = cfg.n_split / cfg.q_split
    args["dsw_tracer_acc"] = (qx, qx, s.pd_x, out.uct_pad * r,
                              out.vct_pad * r, out.mfx_pad * r,
                              out.mfy_pad * r, ctx.metrics, dt, cfg.hord)
    return args


def run_preset(torch, np, model, counters, label, card, expect):
    """Rest state, 3 + STEPS steps with every count reset just before and
    read just after, finiteness, mass drift.  Returns (ms/step,
    {kernel: launches})."""
    from geosongpu_tpu_torch.core.state import state_to_numpy

    cfg = model.config
    s = model.dynamics(model.init(perturb=0.0))
    umax = max(float(s.u.abs().max()), float(s.v.abs().max()))
    ps_dev = float((s.ps / 1.0e5 - 1.0).abs().max())
    print(f"[{label}] rest state after one dynamics step: max|u,v| {umax}, "
          f"max|ps/1e5 - 1| {ps_dev:.3e}")
    if umax != 0.0 or not ps_dev <= 1e-6:
        fail(f"{label}: rest state did not stay at rest")

    s = model.init(perturb=1e-3)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    for _ in range(3):
        s = model.step(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        s = model.step(s)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / STEPS
    launches = {k: fn.launches for k, fn in counters.items()}
    n = 3 + STEPS
    for k, per_step in expect.items():
        if launches[k] != per_step * n:
            fail(f"{label}: {k} launched {launches[k]} times in {n} steps, "
                 f"expected {per_step * n}")
    bad = [k for k, a in state_to_numpy(s).items() if not np.isfinite(a).all()]
    if bad:
        fail(f"{label}: non-finite fields after {n} steps: {bad}")
    print(f"[{label}] c{cfg.npx}-L{cfg.npz}: {sec * 1e3:.2f} ms/step, "
          f"{cfg.grid_points / sec:.4e} gridpoints/s ({STEPS} steps after 3 "
          f"warm-up; {card}); launches in {n} steps: "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; ps {float(s.ps.min()):.1f}..{float(s.ps.max()):.1f} Pa")

    s = model.init(perturb=0.5)
    w = np.asarray(model.grid.area)[model.grid.interior][..., None]
    m0 = float((w * s.delp.double().cpu().numpy()).sum())
    for _ in range(10):
        s = model.dynamics(s)
    m1 = float((w * s.delp.double().cpu().numpy()).sum())
    drift = abs(m1 - m0) / m0
    print(f"[{label}] mass drift over 10 dynamics steps: {drift:.3e}")
    if not drift < 1e-5:
        fail(f"{label}: mass drift {drift:.3e} >= 1e-5")
    return sec * 1e3, launches


def card_vs_cpu(torch, np, preset, dev, label):
    from geosongpu_tpu_torch.core.state import state_from_numpy, state_to_numpy
    from geosongpu_tpu_torch.models.held_suarez import build_model

    small = dataclasses.replace(preset, npx=12, npz=8, dt=1200.0, n_split=2)
    m_cpu = build_model(small, torch.device("cpu"))
    m_gpu = build_model(small, dev)
    start = state_to_numpy(m_cpu.init(perturb=3.0))
    rng = np.random.default_rng(5)
    start["q"] = (1.0 + 0.2 * rng.random(start["q"].shape)).astype(np.float32)
    a = state_to_numpy(m_cpu.run(state_from_numpy(start, "cpu"), 3))
    b = state_to_numpy(m_gpu.run(state_from_numpy(start, dev), 3))
    diffs = {}
    for f in ("u", "v", "delp", "pt", "q", "ps"):
        if a[f].shape != b[f].shape or not np.isfinite(b[f]).all():
            fail(f"{label} card vs CPU at c12-L8: {f} has shape "
                 f"{b[f].shape} on the card, {a[f].shape} on the CPU, or is "
                 "not finite")
        scale = float(np.abs(a[f]).max())
        d = float(np.abs(a[f] - b[f]).max())
        diffs[f] = d / scale
        atol = SLICE_WIND_ATOL if f in ("u", "v") else 0.0
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
    results = {}   # kernel -> (max_abs_err, ms, plain_ms)

    # ---- 3. remap_banded against its plain version ------------------------
    preset = PRESETS["held_suarez_c48_l72"]
    band, K, n = preset.remap_band, preset.npz, preset.npx
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = [("pt+q", (6, n, n), 2, 300.0), ("u", (6, n + 1, n), 1, 10.0),
              ("v", (6, n, n + 1), 1, 10.0)]
    max_abs_err, kernel_ms, plain_ms = 0.0, 0.0, 0.0
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
        print(f"[kernel] remap_banded {label} {nf}x{tuple(qs[0].shape)}: max "
              f"rel err {rel:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(median of 20; {card})")
    print(f"[kernel] remap_banded, one step's 3 calls: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
    results["remap_banded"] = (max_abs_err, kernel_ms, plain_ms)

    # ---- 4. the fused substep kernels against their plain versions ------
    eager = build_model(preset, dev)
    args = kernel_inputs(torch, np, eager, dev)
    for kname, a in args.items():
        kern, plain = getattr(dsw, kname), getattr(dsw, kname + "_plain")
        got, want = kern(*a), plain(*a)
        torch.cuda.synchronize()
        err, rel = compare(kname, got, want, KERNELS[kname][2])
        k_ms = median_ms(torch, lambda: kern(*a))
        p_ms = median_ms(torch, lambda: plain(*a))
        results[kname] = (err, k_ms, p_ms)
        print(f"[kernel] {kname} {tuple(got[0].shape)}: max abs err "
              f"{err:.3e}, max rel err {rel:.3e}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms (median of 20; {card})")
    a = args["dsw_wind"][:-1] + (0.05,)
    err, rel = compare("dsw_wind (vtx_damp 0.05)", dsw.dsw_wind(*a),
                       dsw.dsw_wind_plain(*a), True)
    print(f"[kernel] dsw_wind with vtx_damp 0.05: max abs err {err:.3e}")
    del args, a

    # ---- 5./6. the eager and the fused main path -------------------------
    eager_ms, _ = run_preset(torch, np, eager, counters, "eager", card,
                             {"remap_banded": 3, "dsw_csw1": 0})
    fused_preset = PRESETS["held_suarez_c48_l72_fused"]
    fused = build_model(fused_preset, dev)
    fused_ms, launches = run_preset(torch, np, fused, counters, "fused", card,
                                    FUSED_PER_STEP)
    print(f"[main] c48-L72 in one call: eager {eager_ms:.2f} ms/step, fused "
          f"{fused_ms:.2f} ms/step ({card})")

    # ---- 7. profiler window ---------------------------------------------
    profile_steps(torch, eager, "eager", card)
    profile_steps(torch, fused, "fused", card)
    del eager, fused

    # ---- 8. card against CPU ----------------------------------------------
    card_vs_cpu(torch, np, preset, dev, "eager")
    card_vs_cpu(torch, np, fused_preset, dev, "fused")

    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"geosongpu_tpu_torch/csrc/{src}",
        "replaces": tpu,
        "launches": launches[k],
        "max_abs_err": results[k][0],
        "ms": results[k][1],
        "plain_ms": results[k][2],
    } for k, (src, tpu, _) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card, and exits non-zero
on any failure (and when no CUDA device is present).  Phases:

1. device: the card's name and power limit (nvidia-smi), the toolchain;
2. build: the remap_banded CUDA kernel from the checkout's sources;
3. kernel against its plain PyTorch version at the three c48-L72
   main-path shapes (max error relative to the plain output <= 1e-5),
   with the median time of each over 20 calls;
4. the main path: the Held-Suarez c48-L72 preset through build_model /
   init / step - rest state stays at rest, 3 + 20 steps stay finite,
   pure dynamics conserve mass, the kernel launches 3 times per step;
5. card against CPU: 3 steps at c12-L8 from one numpy state on both.

The second-to-last line is the kernels JSON object, the last line
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
SLICE_GATE = 1e-4        # card vs CPU after 3 steps (whole-slice gate)
SLICE_WIND_ATOL = 6e-3   # m/s


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
        from geosongpu_tpu_torch.core.state import (state_from_numpy,
                                                    state_to_numpy)
        from geosongpu_tpu_torch.models.held_suarez import build_model
        from geosongpu_tpu_torch.ops.kernels import remap as kremap
        from geosongpu_tpu_torch.ops.remap import remap_fields_banded
    except ImportError as e:
        fail(f"run from the root of a checkout (port not importable: {e})")
    dev = torch.device("cuda")

    # ---- 1. device ------------------------------------------------------
    card = card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    has_triton = importlib.util.find_spec("triton") is not None
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; triton importable: {has_triton}; "
          f"nvcc: {kremap.find_nvcc()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = kremap.load_library()
    print(f"[build] remap_banded: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    # ---- 3. kernel against its plain version -----------------------------
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
        rel = 0.0
        for g, w in zip(got, want):
            if not (bool(torch.isfinite(g).all())
                    and bool(torch.isfinite(w).all())):
                fail(f"non-finite remap output at {label}")
            err = float((g - w).abs().max())
            field_rel = err / float(w.abs().max())
            if not field_rel <= REL_GATE:
                fail(f"kernel vs plain at {label} {tuple(g.shape)}: "
                     f"relative error {field_rel:.3e} > {REL_GATE}")
            rel = max(rel, field_rel)
            max_abs_err = max(max_abs_err, err)
        k_ms = median_ms(torch, lambda: kremap.remap_banded(
            qs, pe1, pe2, preset.kord, band))
        p_ms = median_ms(torch, lambda: remap_fields_banded(
            qs, pe1, pe2, preset.kord, band))
        kernel_ms += k_ms
        plain_ms += p_ms
        print(f"[kernel] {label} {nf}x{tuple(qs[0].shape)}: max rel err "
              f"{rel:.3e}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(median of 20; {card})")
    print(f"[kernel] one step's 3 calls: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({card})")

    # ---- 4. main path ---------------------------------------------------
    model = build_model(preset, dev)
    s = model.dynamics(model.init(perturb=0.0))
    umax = max(float(s.u.abs().max()), float(s.v.abs().max()))
    ps_dev = float((s.ps / 1.0e5 - 1.0).abs().max())
    print(f"[main] rest state after one dynamics step: max|u,v| {umax}, "
          f"max|ps/1e5 - 1| {ps_dev:.3e}")
    if umax != 0.0 or not ps_dev <= 1e-6:
        fail("rest state did not stay at rest")

    s = model.init(perturb=1e-3)
    kremap.remap_banded.launches = 0
    for _ in range(3):
        s = model.step(s)
    torch.cuda.synchronize()
    steps = 20
    t0 = time.perf_counter()
    for _ in range(steps):
        s = model.step(s)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / steps
    launches = kremap.remap_banded.launches
    if launches != 3 * (3 + steps):
        fail(f"remap_banded launched {launches} times in {3 + steps} steps, "
             f"expected {3 * (3 + steps)}")
    bad = [k for k, a in state_to_numpy(s).items() if not np.isfinite(a).all()]
    if bad:
        fail(f"non-finite fields after {3 + steps} steps: {bad}")
    print(f"[main] c{n}-L{K}: {sec * 1e3:.2f} ms/step, "
          f"{preset.grid_points / sec:.4e} gridpoints/s (eager torch, "
          f"{steps} steps after 3 warm-up; {card}); remap_banded launches "
          f"{launches} = 3/step; ps {float(s.ps.min()):.1f}.."
          f"{float(s.ps.max()):.1f} Pa")

    s = model.init(perturb=0.5)
    w = np.asarray(model.grid.area)[model.grid.interior][..., None]
    m0 = float((w * s.delp.double().cpu().numpy()).sum())
    for _ in range(10):
        s = model.dynamics(s)
    m1 = float((w * s.delp.double().cpu().numpy()).sum())
    drift = abs(m1 - m0) / m0
    print(f"[main] mass drift over 10 dynamics steps: {drift:.3e}")
    if not drift < 1e-5:
        fail(f"mass drift {drift:.3e} >= 1e-5")

    # ---- 5. card against CPU --------------------------------------------
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
            fail(f"card vs CPU at c12-L8: {f} has shape {b[f].shape} on the "
                 f"card, {a[f].shape} on the CPU, or is not finite")
        scale = float(np.abs(a[f]).max())
        d = float(np.abs(a[f] - b[f]).max())
        diffs[f] = d / scale
        atol = SLICE_WIND_ATOL if f in ("u", "v") else 0.0
        if not d <= max(SLICE_GATE * scale, atol):
            fail(f"card vs CPU at c12-L8: {f} differs by {d:.3e} "
                 f"(max {scale:.3e})")
    print("[cpu-vs-card] c12-L8, 3 steps, max rel diff: "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))

    print(json.dumps({"kernels": [{
        "name": "remap_banded",
        "route": "cuda",
        "source": "geosongpu_tpu_torch/csrc/remap_banded.cu",
        "replaces": "geosongpu_tpu/ops/pallas/remap.py:28",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

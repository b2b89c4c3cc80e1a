"""Measured per-kernel roofline of a Held-Suarez preset's step on the card
(the counterpart of scripts/roofline.py, for the H100).

    python -m geosongpu_tpu_torch.scripts.roofline
        [--preset held_suarez_c48_l72_fused] [--npx N] [--npz K]
        [--steps 5] [--out .ci_workspace/roofline.json]

Traces `--steps` steps with benchmark/profiler.trace and joins, per kernel
wrapper of the step:

  * device time: the trace's kernel events summed per `__global__` name
    (device_op_times), and per wrapper by walking the port's stages in
    stream order: a wrapper's launch runs its leading stages
    (fvtp2d_tile, hydro_columns) and ends with the stage of STAGE_OWNER;
  * bytes: each launch's own input and output tensors, reckoned as the
    kernel's bound reckons them (benchmark/bounds.py: each input read and
    each output written once, of the metrics only those its stages read);
  * operations: OPS_PER_POINT per output point at 67 TFLOP/s of float32.

and reports launches a step, achieved GB/s, the share of the card's
3.35 TB/s and the bound, and the kernels' sum against the trace's device
busy time (hws/xprof_util.device_busy).  The wall time a step is taken
under the profiler and the recorder, which add host time.  It holds no
TPU peak and no HLO cost analysis.  Needs the card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import sys
import tempfile
from collections import defaultdict

from . import card_line, device_of, hs_presets

# __global__ stage -> the wrapper whose launch it ends; the stages not
# named here (fvtp2d_tile, hydro_columns) lead into the next ending stage
STAGE_OWNER = {
    "csw1": "dsw_csw1", "csw2_winds": "dsw_csw2",
    "transport_update": "dsw_transport",
    "nh_transport_update": "dsw_transport", "wind_update": "dsw_wind",
    "tracer_update": "dsw_tracer_acc", "tracer_sub_update": "dsw_tracer",
    "nh_columns": "dsw_nh_pert", "remap_banded_kernel": "remap_banded",
    "gfdl_microphysics_columns": "gfdl_microphysics",
    "fill_q2_zero_columns": "fill_q2_zero",
    "aer_activation_points": "aer_activation",
    "moist_rad_coup_points": "moist_rad_coup",
    "cup_gf_sh_points": "cup_gf_sh", "buoyancy_points": "buoyancy",
    "evap_subl_pdf_points": "evap_subl_pdf",
}
LEADING = ("fvtp2d_tile", "hydro_columns")


def stage_of(name: str):
    """The port's stage a kernel event names ("...::csw1(...)",
    "...::fvtp2d_tile<2>(...)"), or None for any other kernel."""
    for stage in tuple(STAGE_OWNER) + LEADING:
        if f"::{stage}(" in name or f"::{stage}<" in name:
            return stage
    return None


def kernel_events(trace_dir: str) -> list:
    """(start us, duration us, name) of the newest trace's kernel events,
    in start order."""
    from ..hws.xprof_util import newest_trace

    path = newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    return sorted((e["ts"], e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "kernel")


def device_op_times(trace_dir: str) -> dict:
    """{__global__ name: total device us} of the newest trace."""
    times = defaultdict(float)
    for _, dur, name in kernel_events(trace_dir):
        times[name] += dur
    return dict(times)


def wrapper_times(events) -> dict:
    """{wrapper: total device us} of the port's kernels among `events`: a
    leading stage's time goes to the launch its next ending stage ends.
    Raises on a leading stage with no ending stage after it."""
    times, pending = defaultdict(float), 0.0
    for _, dur, name in events:
        stage = stage_of(name)
        if stage in LEADING:
            pending += dur
        elif stage is not None:
            times[STAGE_OWNER[stage]] += pending + dur
            pending = 0.0
    if pending:
        raise ValueError("a leading stage without the stage that ends its "
                         "launch")
    return dict(times)


def form_of(name: str, args) -> str:
    """The key of benchmark/bounds.py's tables for one call of wrapper
    `name` with `args`."""
    if name == "dsw_transport" and len(args) > 9 and args[9] is not None:
        return "dsw_transport nh"
    if name == "dsw_wind":
        if len(args) > 14 and args[14] is not None:
            return "dsw_wind nh"
        if args[7] is None:
            return "dsw_wind blend"
    return name


@contextlib.contextmanager
def recording(calls: list):
    """Record every call of the dycore's kernel wrappers in the block as
    (wrapper, form, input bytes + output bytes, points): the dsw_* wrappers
    (dycore/sw_fused.py calls them through the module) and remap_banded
    (through dycore/fv_dynamics.py's name).  Each wrapper's launch count
    is kept across the block."""
    from ..benchmark.bounds import METRICS_READ, VTX_METRICS, moved_bytes, \
        tensors_of
    from ..dycore import fv_dynamics
    from ..ops.kernels import dsw

    def recorder(orig, name):
        def rec(*args, **kw):
            out = orig(*args, **kw)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            form = form_of(name, args)
            metrics = METRICS_READ[form]
            if name == "dsw_wind" and len(args) > 13 and args[13] > 0.0:
                metrics = metrics + VTX_METRICS
            if name == "remap_banded":
                ins = list(args[0]) + [args[1], args[2]]
                points = sum(t.numel() for t in outs)
            else:
                ins = tensors_of(args, metrics)
                points = max(t.numel() for t in outs)
            calls.append((name, form, moved_bytes(ins, outs), points))
            return out
        rec.launches = orig.launches
        return rec

    patched = [(dsw, k.__name__, k) for k in dsw.KERNELS] + [
        (fv_dynamics, "remap_banded", fv_dynamics.remap_banded)]
    # inside a wrapper, `<name>.launches += 1` reads the module's name,
    # which is the recorder while the block runs
    recs = [(mod, name, orig, recorder(orig, name))
            for mod, name, orig in patched]
    for mod, name, _, rec in recs:
        setattr(mod, name, rec)
    try:
        yield calls
    finally:
        for mod, name, orig, rec in recs:
            setattr(mod, name, orig)
            if mod is dsw:
                orig.launches = rec.launches


def roofline(model, state, steps: int) -> dict:
    """Trace `steps` steps of `model` from `state` on the card and join
    device time, launches, bytes and the bound per kernel."""
    import time

    import torch

    from ..benchmark.bounds import (F32_FLOP_PER_S, HBM_BYTES_PER_S,
                                    OPS_PER_POINT)
    from ..benchmark.profiler import trace
    from ..device import synchronize
    from ..hws.xprof_util import device_busy
    from ..ops.kernels import launch_counts

    device = model.device
    if device.type != "cuda":
        raise RuntimeError("a roofline measures the card: needs a CUDA model")
    calls = []
    before = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with recording(calls):
            synchronize(device)
            with trace(tmp, device):
                t0 = time.perf_counter()
                for _ in range(steps):
                    state = model.step(state)
                synchronize(device)
                wall = (time.perf_counter() - t0) / steps
        events = kernel_events(tmp)
        per_name = device_op_times(tmp)
        busy = device_busy(tmp)
    launches = {k: n - before[k] for k, n in launch_counts().items()
                if n > before[k]}
    dev_us = wrapper_times(events)
    moved, ops = defaultdict(float), defaultdict(float)
    for name, form, nbytes, points in calls:
        moved[name] += nbytes
        ops[name] += OPS_PER_POINT[form] * points
    missing = sorted(set(moved) - set(dev_us))
    if missing:
        raise RuntimeError(f"the trace names no stage of {missing}")
    kernels = {}
    for name in sorted(moved, key=lambda k: -dev_us[k]):
        secs = dev_us[name] / 1e6 / steps
        gbytes = moved[name] / steps / 1e9
        by_bytes = gbytes * 1e9 / HBM_BYTES_PER_S
        by_ops = ops[name] / steps / F32_FLOP_PER_S
        kernels[name] = {
            "launches_per_step": launches.get(name, 0) / steps,
            "bytes_per_launch": moved[name] / max(1, launches.get(name, 0)),
            "gbytes_per_step": gbytes,
            "device_ms_per_step": 1e3 * secs,
            "achieved_gb_s": gbytes / secs,
            "share_of_hbm": by_bytes / secs,
            "bound_ms_per_step": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        }
    total_us = sum(dev_us.values())
    cfg = model.config
    return {
        "config": {"npx": cfg.npx, "npz": cfg.npz, "n_split": cfg.n_split,
                   "pallas_dycore": cfg.pallas_dycore, "steps": steps},
        "card": card_line(device),
        "peaks": {"hbm_bytes_s": HBM_BYTES_PER_S,
                  "f32_flop_s": F32_FLOP_PER_S},
        "wall_ms_per_step": 1e3 * wall,
        "device_busy_ms_per_step": 1e3 * busy["busy_s"] / steps,
        "kernels_device_ms_per_step": total_us / 1e3 / steps,
        "kernels_share_of_busy": (total_us / 1e6 / busy["busy_s"]
                                  if busy["busy_s"] else None),
        "device_op_ms_per_step": {k: v / 1e3 / steps for k, v in sorted(
            per_name.items(), key=lambda kv: -kv[1])},
        "kernels": kernels,
        "method": "device time from the trace's kernel events, per wrapper "
                  "by the port's stages in stream order; bytes from each "
                  "launch's tensors (benchmark/bounds.py)",
        "torch": torch.__version__,
    }


def main(argv=None) -> int:
    from ..cli import PRESETS, build_model_for

    ap = argparse.ArgumentParser(prog="roofline")
    ap.add_argument("--preset", default="held_suarez_c48_l72_fused",
                    choices=hs_presets())
    ap.add_argument("--npx", type=int, default=None)
    ap.add_argument("--npz", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(".ci_workspace",
                                                  "roofline.json"))
    args = ap.parse_args(argv)
    device = device_of("cuda")
    cfg = PRESETS[args.preset]
    cfg = dataclasses.replace(cfg, npx=args.npx or cfg.npx,
                              npz=args.npz or cfg.npz)
    model = build_model_for(args.preset)(cfg, device)
    state = model.run(model.init(perturb=1e-3), 3)
    artifact = roofline(model, state, args.steps)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The dual-build gate of the standalone physics kernels
(geosongpu_tpu/harness/tasks/physics_standalone.py, as plain functions).

The reference builds each physics kernel twice and requires the two builds
to agree within 0.01% per variable over five datasets.  Here build 1 is the
primary of physics/standalone.py in plain PyTorch (`run_kernel`) and build
2 the hand-written kernel behind its wrapper (`run_kernel_fused`): a CUDA
kernel for data on a card, the kernel's plain version on the CPU.  All
seven pairs are two sources: the twins and the microphysics kernel are
re-derivations, the other four kernels are written from the formulas.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..device import to_numpy, to_torch
from ..ops.kernels import columns as kcolumns
from ..ops.kernels import microphysics as kmicro
from ..ops.kernels import standalone_twins as ktwins
from . import standalone as K

N_DATASETS = 5          # input indices 0..4, seeds 1000 + index
REL_TOL = 1e-4          # 0.01%
SHAPE = (128, 40)       # columns x levels
DT = 600.0


class GateMiss(Exception):
    """A variable of a kernel left the gate."""


def datasets(seed: int, shape=SHAPE) -> Dict[str, np.ndarray]:
    """One synthetic input set: a smooth sounding with noise, condensate
    and a tracer with negative values.  The gate runs SHAPE; kernel checks
    also take other (columns, levels)."""
    rng = np.random.default_rng(seed)
    shape = tuple(shape)
    ncol, nz = shape
    p = np.linspace(2000.0, 1.0e5, nz)[None, :] * np.ones((ncol, 1))
    t = 220.0 + 80.0 * (p / 1.0e5) ** 0.28 + rng.normal(0, 2, shape)
    qv = np.clip(0.8 * 0.622 * 611.2 *
                 np.exp(17.67 * (t - 273.16) / (t - 30.06)) / p
                 + rng.normal(0, 1e-4, shape), 1e-7, 0.03)
    return {
        "t": t.astype(np.float32),
        "qv": qv.astype(np.float32),
        "ql": np.clip(rng.normal(2e-4, 2e-4, shape), 0, None).astype(np.float32),
        "qi": np.clip(rng.normal(5e-5, 5e-5, shape), 0, None).astype(np.float32),
        "qr": np.clip(rng.normal(1e-4, 1e-4, shape), 0, None).astype(np.float32),
        "q_neg": rng.normal(1e-4, 3e-4, shape).astype(np.float32),
        "p": p.astype(np.float32),
        "delp": np.gradient(p, axis=1).astype(np.float32),
        "w": np.abs(rng.normal(0.5, 0.3, shape)).astype(np.float32),
        "num_aer": np.abs(rng.normal(1e8, 3e7, shape)).astype(np.float32),
    }


# kernel name -> (primary, hand-kernel wrapper, output names (None: the
# function returns a dict), its arguments from a dataset)
_TABLE = {
    "FillQ2Zero": (K.fill_q2_zero, kcolumns.fill_q2_zero, ("q",),
                   lambda d: (d["q_neg"], d["delp"])),
    "Buoyancy": (K.buoyancy, ktwins.buoyancy, ("b",),
                 lambda d: (d["t"], d["qv"], d["p"], d["t"] + 0.5, d["qv"])),
    "EvapSublPdfLoop": (K.evap_subl_pdf, ktwins.evap_subl_pdf,
                        ("t", "qv", "ql", "qi"),
                        lambda d: (d["t"], d["qv"], d["ql"], d["qi"], d["p"],
                                   DT)),
    "AerActivation": (K.aer_activation, kcolumns.aer_activation, ("nact",),
                      lambda d: (d["num_aer"], d["w"], d["t"], d["p"])),
    "GFDLMicrophysics": (K.gfdl_microphysics, kmicro.gfdl_microphysics,
                         K.MicrophysicsOut._fields,
                         lambda d: (d["t"], d["qv"], d["ql"], d["qr"],
                                    d["qi"], d["p"], d["delp"], DT)),
    "MoistRadCoup": (K.moist_rad_coup, kcolumns.moist_rad_coup, None,
                     lambda d: (d["ql"], d["qi"], d["p"], d["t"])),
    "CupGfSh": (K.cup_gf_sh, kcolumns.cup_gf_sh, ("t", "qv"),
                lambda d: (d["t"], d["qv"], d["p"], d["delp"], DT)),
}


def arguments(name: str, data):
    """The arguments kernel `name` takes from the dataset `data`."""
    return _TABLE[name][3](data)


def _build(which: int) -> Dict[str, Callable]:
    def one(fn, names, args):
        def run(d):
            out = fn(*args(d))
            if names is None:
                return out
            return dict(zip(names, (out,) if len(names) == 1 else out))
        return run
    return {name: one(row[which], row[2], row[3])
            for name, row in _TABLE.items()}


# kernel name -> callable(data) -> dict of outputs
KERNELS: Dict[str, Callable] = _build(0)   # build 1, the primaries
FUSED: Dict[str, Callable] = _build(1)     # build 2, the hand kernels
WRAPPERS = {name: row[1] for name, row in _TABLE.items()}


def _run(table, name: str, data, device) -> Dict[str, np.ndarray]:
    d = {k: to_torch(v, device) for k, v in data.items()}
    return {k: to_numpy(v) for k, v in table[name](d).items()}


def run_kernel(name: str, data, device) -> Dict[str, np.ndarray]:
    """Build 1: the primary in plain PyTorch on `device`."""
    return _run(KERNELS, name, data, device)


def run_kernel_fused(name: str, data, device) -> Dict[str, np.ndarray]:
    """Build 2: the hand kernel (on a card) or its plain version (on the
    CPU)."""
    return _run(FUSED, name, data, device)


def check(ref: Dict[str, np.ndarray], opt: Dict[str, np.ndarray]
          ) -> Dict[str, float]:
    """Relative RMS difference per variable; raises GateMiss where one is
    not finite or above REL_TOL."""
    if set(ref) != set(opt):
        raise GateMiss(f"outputs differ: {sorted(ref)} vs {sorted(opt)}")
    rels = {}
    for var, a in ref.items():
        a = a.astype(np.float64)
        scale = np.sqrt(np.mean(a ** 2)) or 1.0
        rel = float(np.sqrt(np.mean((opt[var] - a) ** 2)) / scale)
        if not np.isfinite(rel) or rel > REL_TOL:
            raise GateMiss(f"var {var}: rel RMS {rel:.3e} > {REL_TOL}")
        rels[var] = rel
    return rels


def run_gate(name: str, device) -> float:
    """The gate of kernel `name` over the N_DATASETS datasets on `device`:
    the worst relative RMS, or GateMiss naming the dataset and variable."""
    worst = 0.0
    for i in range(N_DATASETS):
        data = datasets(1000 + i)
        try:
            rels = check(run_kernel(name, data, device),
                         run_kernel_fused(name, data, device))
        except GateMiss as e:
            raise GateMiss(f"{name} dataset {i} {e}") from None
        worst = max(worst, *rels.values())
    return worst

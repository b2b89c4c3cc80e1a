"""Frozen copy of geosongpu_tpu_torch/core/config.py at commit f902e7ad95fb,
unchanged but for this note.

Typed configuration tree for the dycore + experiments
(the port's own copy of geosongpu_tpu/core/config.py).

One serializable tree: experiment -> model -> mesh -> run lengths.  The
field names and defaults are those of the JAX package's DycoreConfig
(tests/test_torch_core.py holds the two together), so one dict of keyword
arguments builds the same configuration for both.  Options that name a
Pallas kernel select this package's hand-written CUDA kernel of the same
role; dycore/fv_dynamics.py::check_supported lists what is refused.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DycoreConfig:
    """Numerical configuration of the finite-volume dynamical core."""

    npx: int = 48           # cells per cube-face edge (c48 -> npx=48)
    npz: int = 32           # vertical layers
    ptop: float = 100.0     # model-top pressure [Pa]
    dt: float = 600.0       # physics/remap timestep [s]
    k_split: int = 1        # vertical remap loops per dt
    n_split: int = 6        # dynamics substeps per remap loop
    hord: int = 8           # tracer horizontal advection: 8=monotone PPM,
                            # 6=unlimited 4th-order
    hord_mt: int = 0        # momentum/vorticity-flux PPM variant; 0 =
                            # follow `hord`.  FV3 production runs hord_mt=6
                            # (unlimited - the limiter is pure VPU flops and
                            # momentum needs no monotonicity); gated by the
                            # stability suite + climatology smoke
    hord_tm: int = 0        # delp/pt/w/delz PPM variant; 0 = follow `hord`
    kord: int = 8           # vertical remap PPM variant (monotone)
    d2_bg: float = 0.015    # 2nd-order divergence damping coefficient
    vtx_damp: float = 0.0   # optional vorticity damping
    hydrostatic: bool = True
    ntracers: int = 1
    halo: int = 3
    z_tracer: bool = True   # advect tracers once per remap interval with
                            # accumulated mass fluxes (FV3 z_tracer); False
                            # sub-cycles tracers every acoustic substep
    q_split: int = 2        # tracer subcycles per remap interval (Courant
                            # control for the accumulated fluxes)
    pallas_microphysics: bool = False  # fused kernel for the
                                       # GFDL-lite microphysics column chain
    pallas_dycore: bool = False  # run the d_sw substep chain as fused
                                 # kernels (dycore/sw_fused.py); same
                                 # math, fused scheduling
    pallas_kt: int = 0           # vertical tile for the dycore kernels
                                 # (0 = whole column per block)
    pallas_jt: int = 0           # J-row tile for the dycore kernels
                                 # (ignored here: the CUDA kernels have
                                 # no row tiling)
    remap_band: int = 6   # banded vertical remap half-width in layers.
                          # Measured Lagrangian deformation (|omga| dt /
                          # delp) is ~0.01 layers through c48 spin-up and
                          # O(1) layer in mature storm-track eddies; the
                          # HeldSuarez check gates BOTH the measured
                          # deformation (< band/2) and banded-vs-full
                          # agreement on a coordinate displaced by
                          # band/2 layers, every run.
                          # > 0 selects the banded remap kernel
                          # (ops/kernels/remap.py): exact while Lagrangian
                          # deformation stays within the band, O(K*band)
                          # work.  0 = full form everywhere.
    vertical: str = "hybrid"  # "sigma" | "hybrid"
    dtype: str = "float32"  # the port runs float32 only
    w_sponge_p: float = 0.0   # NH mode: Rayleigh-damp w where p < this
                              # [Pa] (model-top acoustic/gravity-wave
                              # sponge; 0 = off)
    w_sponge_tau: float = 3600.0  # sponge e-folding time [s]
    edge_symmetrize: bool = True  # average the two prognosed copies of
                                  # every shared face-edge staggered wind
                                  # after each step (kills shared-edge
                                  # rounding drift; exact-arithmetic
                                  # no-op)
    chart_corners: bool = True  # cube-corner chart consistency: corner
                                # L-regions of every fill resampled onto
                                # the analytically-extended chart
                                # (core/chart_corners.py) and the basis
                                # metrics evaluated there; fixes the
                                # corner-block chimera AND halves scalar
                                # halo fills (x-fill == y-fill after
                                # correction).  False = uncorrected fills.
    damping_exchange: str = "auto"  # damping-divergence formulation:
                             # "exchange" = owner-side normal fields +
                             # staggered chart resample (dual structure
                             # everywhere except the corner disks - full
                             # D-grid checkerboard control; costs one
                             # staggered exchange per substep);
                             # "blend" = in-kernel dual/cell blend over
                             # the edge bands (no glue; the bands are
                             # checkerboard-blind, which at c12 covers
                             # most of the face);
                             # "auto" = exchange for npx <= 96, blend
                             # above.
    rim_split: bool = False  # split the c_sw stage into an interior
                             # core computed from local (un-exchanged)
                             # winds and rim bands from the exchanged
                             # fills (pays only across devices; refused
                             # by this package's check_supported)
    overlap_fills: bool = False  # pipeline scalar halo exchanges across
                                 # acoustic substeps (pays only across
                                 # devices; refused by check_supported)

    @property
    def grid_points(self) -> int:
        return 6 * self.npx * self.npx * self.npz


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: how the cubed sphere maps onto devices
    (the analog of an MPI layout matrix, 1x1/3x4/4x4 per face).  Axes:
      face: 1 or 6   - shard the 6 faces
      x, y: subtile decomposition within a face
    Total devices = face * x * y.
    """

    face: int = 1
    x: int = 1
    y: int = 1

    @property
    def n_devices(self) -> int:
        return self.face * self.x * self.y


@dataclass(frozen=True)
class RunConfig:
    steps: int = 8
    warmup_steps: int = 1
    checkpoint_every: int = 0   # 0 = off
    log_every: int = 0


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "held_suarez_c48"
    model: str = "held_suarez"  # "held_suarez" | "aquaplanet"
    dycore: DycoreConfig = field(default_factory=DycoreConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        d = dict(d)
        for key, sub in (("dycore", DycoreConfig), ("mesh", MeshConfig), ("run", RunConfig)):
            if key in d and isinstance(d[key], dict):
                d[key] = sub(**d[key])
        return cls(**d)

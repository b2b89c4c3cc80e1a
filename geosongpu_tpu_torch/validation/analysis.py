"""Field diff analysis: reference vs computed (the port's copy of
geosongpu_tpu/validation/analysis.py).

Per-variable diff at a time index, NaN-stripped max/min, log-y histogram
of the error distribution (the reference's tcn/validation/analysis.py:7-30),
on .npz state dumps (`core.state.state_to_numpy` written with np.savez;
NetCDF loads via xarray when it is installed, which the card's machine
does not have).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class DiffReport:
    variable: str
    max_diff: float
    min_diff: float
    mean_abs_diff: float
    rms_diff: float
    rel_rms: float
    n_finite: int

    def __str__(self) -> str:
        return (f"{self.variable}: max {self.max_diff:.3e}, "
                f"min {self.min_diff:.3e}, mean|d| {self.mean_abs_diff:.3e}, "
                f"rms {self.rms_diff:.3e} (rel {self.rel_rms:.3e}), "
                f"n={self.n_finite}")


def load_dataset(path: str) -> Dict[str, np.ndarray]:
    """Load a state archive: .npz natively; .nc/.nc4 via xarray if present."""
    if path.endswith((".nc", ".nc4")):
        try:
            import xarray as xr
        except ImportError as e:
            raise RuntimeError(
                "NetCDF input requires xarray; convert to .npz or install "
                "xarray") from e
        ds = xr.open_dataset(path)
        return {k: np.asarray(v) for k, v in ds.items()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def analysis(ref: Dict[str, np.ndarray], computed: Dict[str, np.ndarray],
             variable: str, time_idx: Optional[int] = None,
             histogram_png: Optional[str] = None) -> DiffReport:
    a = np.asarray(ref[variable], dtype=np.float64)
    b = np.asarray(computed[variable], dtype=np.float64)
    if time_idx is not None:
        a = a[time_idx]
        b = b[time_idx]
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch for {variable}: {a.shape} vs {b.shape}")
    diff = b - a
    finite = np.isfinite(diff)
    d = diff[finite]
    scale = np.sqrt(np.mean(a[finite] ** 2)) or 1.0
    rep = DiffReport(
        variable=variable,
        max_diff=float(d.max()) if d.size else float("nan"),
        min_diff=float(d.min()) if d.size else float("nan"),
        mean_abs_diff=float(np.abs(d).mean()) if d.size else float("nan"),
        rms_diff=float(np.sqrt(np.mean(d ** 2))) if d.size else float("nan"),
        rel_rms=float(np.sqrt(np.mean(d ** 2)) / scale) if d.size else float("nan"),
        n_finite=int(d.size),
    )
    if histogram_png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        nz = d[d != 0]
        ax.hist(nz if nz.size else d, bins=80)
        ax.set_yscale("log")
        ax.set_xlabel(f"{variable}: computed - reference")
        ax.set_ylabel("count (log)")
        ax.set_title(str(rep))
        fig.savefig(histogram_png, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return rep


def check_tolerance(ref: Dict[str, np.ndarray],
                    computed: Dict[str, np.ndarray],
                    variables, rel_tol: float = 1e-4) -> bool:
    """The reference's physics gate: each variable within `rel_tol`
    relative RMS (default its 0.01% = 1e-4, tcn/ci/pipeline/
    physics_standalone.py:132-144)."""
    ok = True
    for v in variables:
        rep = analysis(ref, computed, v)
        if not np.isfinite(rep.rel_rms) or rep.rel_rms > rel_tol:
            print(f"TOLERANCE FAIL {rep}")
            ok = False
    return ok

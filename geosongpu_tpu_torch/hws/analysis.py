"""Energy-envelope analysis (the port's copy of geosongpu_tpu/hws/analysis.py):
the trapezoid of the power series, kWh = W x s / 3.6e6.

The original integrates at a fixed spacing of `rate_s`, which is right for
a sampler that wakes every `rate_s` and wrong for one sampled once a model
step.  A dump that carries its samples' times (`t_s`) is integrated over
them; one without (the original's dumps) at `rate_s`, as the original does.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz   # numpy < 2


@dataclass
class EnergyReport:
    cpu_joules: float
    tpu_joules: float      # the schema's name: the card's, on the port

    @property
    def cpu_kwh(self) -> float:
        return self.cpu_joules / 3.6e6

    @property
    def tpu_kwh(self) -> float:
        return self.tpu_joules / 3.6e6

    @property
    def total_kwh(self) -> float:
        return self.cpu_kwh + self.tpu_kwh


# the dump's entries besides the series (written by the port's sampler)
META = ("device", "gpu_name", "gpu_uuid", "power_limit_w")


def load_data(path: str) -> Dict[str, np.ndarray]:
    """A dump of either package's sampler, npz or JSON, as arrays."""
    if path.endswith(".json"):
        with open(path) as f:
            d = json.load(f)
        out = {k: np.asarray(v) for k, v in d["data"].items()}
        out["rate_s"] = np.asarray([d["rate_s"]])
        out["ticks"] = np.asarray(d["ticks"])
        out.update({k: np.asarray(d[k]) for k in META if k in d})
        return out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def integrate(data: Dict[str, np.ndarray], key: str,
              start: int = 0, end: int | None = None) -> float:
    """The trapezoid of series `key` over samples [start, end): over the
    samples' times where the dump has them, else at a spacing of rate_s."""
    y = np.asarray(data[key][start:end], dtype=np.float64)
    if len(y) < 2:
        return 0.0
    if "t_s" in data:
        return float(_trapezoid(y, x=np.asarray(data["t_s"][start:end],
                                                 dtype=np.float64)))
    return float(_trapezoid(y, dx=float(data["rate_s"][0])))


def energy_envelope(data: Dict[str, np.ndarray],
                    start: int = 0, end: int | None = None) -> EnergyReport:
    return EnergyReport(cpu_joules=integrate(data, "cpu_psu", start, end),
                        tpu_joules=integrate(data, "tpu_psu", start, end))

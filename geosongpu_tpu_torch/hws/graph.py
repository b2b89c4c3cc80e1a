"""Time-series plot of a sampler dump (the port's copy of
geosongpu_tpu/hws/graph.py: power, utilization and memory on two axes,
the maxima and the energy in the title).  matplotlib is imported when a
graph is drawn; where it is not installed, `graph` raises RuntimeError."""
from __future__ import annotations

import numpy as np

from . import constants as C
from .analysis import energy_envelope, load_data


def graph(path: str, out_png: str | None = None) -> str:
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(f"drawing a graph needs matplotlib: {e}") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = load_data(path)
    n = len(data["cpu_psu"])
    t = (np.asarray(data["t_s"], dtype=np.float64) if "t_s" in data
         else np.arange(n) * float(data["rate_s"][0]))
    limit_w = float(data.get("power_limit_w", 0.0)) or \
        C.GPU_SPEC["power_limit_w"]

    fig, ax1 = plt.subplots(figsize=(10, 5))
    ax1.plot(t, data["cpu_psu"], label="CPU power [W] (model)",
             color="tab:blue")
    ax1.plot(t, data["tpu_psu"], label="GPU power [W] (NVML)",
             color="tab:red")
    ax1.set_xlabel("time [s]")
    ax1.set_ylabel("power [W]")
    ax1.set_ylim(0, max(limit_w, C.CPU_SPEC["tdp_w"]) * 1.1)

    ax2 = ax1.twinx()
    ax2.plot(t, data["cpu_exe_utl"], label="CPU util [%]",
             color="tab:green", alpha=0.6)
    ax2.plot(t, np.asarray(data["tpu_busy"]) * 100.0,
             label="GPU busy [%] (NVML)", color="tab:green")
    mem_mb = C.GPU_SPEC["mem_mib"] * 1.048576
    ax2.plot(t, data["tpu_mem_mb"] / mem_mb * 100,
             label="GPU mem [%]", color="tab:orange", alpha=0.6)
    ax2.set_ylabel("utilization / memory [%]")
    ax2.set_ylim(0, 105)

    for tick in data.get("ticks", []):
        ax1.axvline(t[min(int(tick), n - 1)], color="gray", linestyle=":",
                    alpha=0.5)

    lines1, labels1 = ax1.get_legend_handles_labels()
    lines2, labels2 = ax2.get_legend_handles_labels()
    ax1.legend(lines1 + lines2, labels1 + labels2, loc="upper right")

    rep = energy_envelope(data)
    ax1.set_title(
        f"max CPU {np.max(data['cpu_psu']):.0f} W, "
        f"max GPU mem {np.max(data['tpu_mem_mb']):.0f} MB, "
        f"energy {rep.total_kwh*1e3:.2f} Wh")

    out = out_png or (path.rsplit(".", 1)[0] + ".png")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"max CPU power: {np.max(data['cpu_psu']):.1f} W")
    print(f"energy envelope: cpu {rep.cpu_kwh*1e3:.3f} Wh, "
          f"gpu {rep.tpu_kwh*1e3:.3f} Wh")
    return out

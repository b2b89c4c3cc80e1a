"""Cubed-sphere field plotting (the port's copy of
geosongpu_tpu/plots/plot_field.py).

The reference's tcn/plots/geos/plot_via_plotly.py:17-107 (mean over
auto-detected extra dims, optional A-B diff, heatmap rendering, PNG
naming), with matplotlib instead of plotly, in a 6-panel "unfolded cube"
layout for [6, y, x] fields.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

# unfolded-cube panel positions (row, col) per face for our frame layout
# (equator ring 0-3, 4 = north above face 0, 5 = south below face 0)
_PANEL = {0: (1, 0), 1: (1, 1), 2: (1, 2), 3: (1, 3), 4: (0, 0), 5: (2, 0)}


def _reduce_to_faces(a: np.ndarray, reduce_dims: Sequence[int] = ()) -> np.ndarray:
    """Reduce an arbitrary field to [6, y, x]: mean over named extra dims,
    then over any remaining trailing dims (reference means over
    tile/time/z automatically, plot_via_plotly.py:17-29)."""
    a = np.asarray(a)
    for d in sorted(reduce_dims, reverse=True):
        a = a.mean(axis=d)
    while a.ndim > 3:
        a = a.mean(axis=-1)
    if a.ndim != 3 or a.shape[0] != 6:
        raise ValueError(f"cannot render shape {a.shape} as cubed-sphere")
    return a


def plot(field: np.ndarray, name: str = "field",
         diff_with: Optional[np.ndarray] = None,
         reduce_dims: Sequence[int] = (),
         out_png: Optional[str] = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = _reduce_to_faces(field, reduce_dims)
    title = name
    if diff_with is not None:
        a = a - _reduce_to_faces(diff_with, reduce_dims)
        title = f"{name} (diff)"

    vmax = np.nanmax(np.abs(a)) or 1.0
    cmap = "RdBu_r" if diff_with is not None else "viridis"
    vmin = -vmax if diff_with is not None else np.nanmin(a)
    vmax2 = vmax if diff_with is not None else np.nanmax(a)

    fig, axes = plt.subplots(3, 4, figsize=(13, 8))
    for ax in axes.flat:
        ax.axis("off")
    im = None
    for f in range(6):
        r, c = _PANEL[f]
        ax = axes[r][c]
        ax.axis("on")
        im = ax.imshow(a[f], origin="lower", cmap=cmap, vmin=vmin, vmax=vmax2)
        ax.set_title(f"face {f}", fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.colorbar(im, ax=axes, shrink=0.7, label=name)
    fig.suptitle(title)

    out = out_png or f"{name.replace('/', '_')}.png"
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out

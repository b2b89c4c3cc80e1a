"""Static comparison dashboard (the port's copy of
geosongpu_tpu/plots/dashboard.py).

The reference's Dash app (3 tabs - Difference / Reference / DSL - of
heatmap grids over all variables of two datasets, tcn/plots/geos/
dash_grid_heatmaps.py:76-136) as a static HTML page of embedded PNGs,
without dash: artifact-friendly (attachable to CI runs), no server
required.  Rendering needs matplotlib.
"""
from __future__ import annotations

import base64
import io
import os
from typing import Dict, Optional

import numpy as np

from .plot_field import _reduce_to_faces


def _panel_png(field: np.ndarray, name: str, diff: bool = False) -> str:
    """Render one unfolded-cube panel to a base64 PNG string."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .plot_field import _PANEL

    a = _reduce_to_faces(field)
    vmax = float(np.nanmax(np.abs(a))) or 1.0
    cmap = "RdBu_r" if diff else "viridis"
    vmin = -vmax if diff else float(np.nanmin(a))
    vmax2 = vmax if diff else float(np.nanmax(a))
    fig, axes = plt.subplots(3, 4, figsize=(8, 5))
    for ax in axes.flat:
        ax.axis("off")
    im = None
    for f in range(6):
        r, c = _PANEL[f]
        ax = axes[r][c]
        ax.axis("on")
        im = ax.imshow(a[f], origin="lower", cmap=cmap, vmin=vmin,
                       vmax=vmax2)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.colorbar(im, ax=axes, shrink=0.6)
    fig.suptitle(name, fontsize=10)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=90, bbox_inches="tight")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def render_html(ref: Dict[str, np.ndarray],
                computed: Dict[str, np.ndarray],
                variables: Optional[list] = None,
                title: str = "reference vs computed",
                live: bool = False) -> str:
    """Render the 3-tab dashboard (Difference / Reference / Computed) as
    an HTML string.  live=True adds the REGENERATE button wired to the
    dashboard server's /reload endpoint (plots/dashboard_server.py) -
    the reference Dash app's re-read-and-rerender workflow."""
    varlist = variables or [k for k in ref
                            if k in computed and np.asarray(ref[k]).ndim >= 3]
    tabs = {"Difference": [], "Reference": [], "Computed": []}
    for v in varlist:
        a = np.asarray(ref[v], dtype=np.float64)
        b = np.asarray(computed[v], dtype=np.float64)
        if a.shape != b.shape:
            continue
        tabs["Difference"].append((v, _panel_png(b - a, f"{v} (diff)",
                                                 diff=True)))
        tabs["Reference"].append((v, _panel_png(a, v)))
        tabs["Computed"].append((v, _panel_png(b, v)))

    sections = []
    nav = []
    for i, (tab, panels) in enumerate(tabs.items()):
        nav.append(f'<button onclick="show({i})" id="b{i}">{tab}</button>')
        imgs = "\n".join(
            f'<figure><img src="data:image/png;base64,{png}" alt="{v}"/>'
            f"</figure>" for v, png in panels)
        sections.append(
            f'<div class="tab" id="t{i}" '
            f'style="display:{"block" if i == 0 else "none"}">{imgs}</div>')

    reload_btn = ("""<button id="regen" onclick="regen()">"""
                  """REGENERATE (re-read files)</button>""" if live else "")
    reload_js = ("""
async function regen() {
  document.getElementById('regen').textContent = 'regenerating...';
  await fetch('/reload', {method: 'POST'});
  location.reload();
}""" if live else "")
    html = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; margin: 1rem; }}
button {{ margin-right: .5rem; padding: .4rem .8rem; }}
figure {{ display: inline-block; margin: .3rem; }}
img {{ max-width: 420px; }}
</style>
<script>
function show(i) {{
  for (let k = 0; k < 3; k++)
    document.getElementById('t'+k).style.display = (k===i) ? 'block' : 'none';
}}{reload_js}
</script></head>
<body><h2>{title}</h2>
<nav>{''.join(nav)}{reload_btn}</nav>
{''.join(sections)}
</body></html>
"""
    return html


def compare_dashboard(ref: Dict[str, np.ndarray],
                      computed: Dict[str, np.ndarray],
                      out_html: str,
                      variables: Optional[list] = None,
                      title: str = "reference vs computed") -> str:
    """Write the dashboard as a STATIC artifact file (CI-attachable)."""
    html = render_html(ref, computed, variables=variables, title=title)
    os.makedirs(os.path.dirname(os.path.abspath(out_html)), exist_ok=True)
    with open(out_html, "w") as f:
        f.write(html)
    return out_html

"""Live comparison dashboard server (the port's copy of
geosongpu_tpu/plots/dashboard_server.py).

The reference's Dash app (tcn/plots/geos/dash_grid_heatmaps.py:76-136):
tabs (Difference / Reference / Computed) served over HTTP from two
dataset files, with a REGENERATE button that re-reads the files from disk
and re-renders - the live-reload workflow the static exporter
(plots/dashboard.py) cannot provide.  A stdlib http.server around the same
unfolded-cube panel renderer: no dash or plotly, matplotlib to render.

Usage:
    geosongpu-tpu-torch-plots serve ref.npz computed.npz --port 8050
or programmatically: DashboardServer(ref_path, comp_path).serve_forever().
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np


def load_dataset(path: str) -> Dict[str, np.ndarray]:
    """.npz directly; NetCDF via xarray when available."""
    if path.endswith((".nc", ".nc4", ".cdf")):
        import xarray as xr

        ds = xr.open_dataset(path)
        return {k: np.asarray(v) for k, v in ds.items()}
    d = np.load(path)
    return {k: np.asarray(d[k]) for k in d.files}


class DashboardServer:
    """Serves the 3-tab dashboard; /reload re-reads the files."""

    def __init__(self, ref_path: str, comp_path: str,
                 variables: Optional[list] = None,
                 title: str = "reference vs computed",
                 host: str = "127.0.0.1", port: int = 8050):
        self.ref_path = ref_path
        self.comp_path = comp_path
        self.variables = variables
        self.title = title
        self._lock = threading.Lock()
        self._html = ""
        self._reloads = 0
        self.regenerate()

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "text/html; charset=utf-8"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    with outer._lock:
                        body = outer._html.encode()
                    self._send(200, body)
                elif self.path == "/status":
                    self._send(200, json.dumps(
                        {"reloads": outer._reloads,
                         "ref": outer.ref_path,
                         "computed": outer.comp_path}).encode(),
                        "application/json")
                else:
                    self._send(404, b"not found")

            def do_POST(self):
                if self.path == "/reload":
                    outer.regenerate()
                    self._send(200, json.dumps(
                        {"ok": True,
                         "reloads": outer._reloads}).encode(),
                        "application/json")
                else:
                    self._send(404, b"not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    # ------------------------------------------------------------------
    def regenerate(self) -> None:
        """Re-read both datasets from disk and re-render (the Dash
        app's regenerate-graphs callback)."""
        from .dashboard import render_html

        ref = load_dataset(self.ref_path)
        comp = load_dataset(self.comp_path)
        html = render_html(ref, comp, variables=self.variables,
                           title=self.title, live=True)
        with self._lock:
            self._html = html
            self._reloads += 1

    def serve_forever(self):
        print(f"dashboard at http://127.0.0.1:{self.port}/  "
              "(POST /reload or use the button to re-read the files)")
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()

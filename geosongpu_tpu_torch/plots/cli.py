"""Plot CLI of the port (geosongpu_tpu/plots/cli.py, the reference's
tcn/plots/cli.py:8-42):

    geosongpu-tpu-torch-plots plot FILE VAR [-d dim]... [--diff_with B]
        [-st t] [--out PNG]
    geosongpu-tpu-torch-plots dash_compare REF COMPUTED [--out HTML]
    geosongpu-tpu-torch-plots serve REF COMPUTED [--port P] [--host H]

Drawing needs matplotlib, which the card's machine does not have: plot
the .npz files the card wrote on a host that has it.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="geosongpu-tpu-torch-plots")
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("plot")
    pl.add_argument("file")
    pl.add_argument("variable")
    pl.add_argument("-d", "--reduce_dim", type=int, action="append",
                    default=[])
    pl.add_argument("--diff_with", default=None)
    pl.add_argument("-st", "--select_time", type=int, default=None)
    pl.add_argument("--out", default=None)

    dc = sub.add_parser("dash_compare")
    dc.add_argument("reference")
    dc.add_argument("computed")
    dc.add_argument("--out", default="dashboard.html")

    sv = sub.add_parser(
        "serve", help="live dashboard server with a reload endpoint "
        "(the reference's Dash app role)")
    sv.add_argument("reference")
    sv.add_argument("computed")
    sv.add_argument("--port", type=int, default=8050)
    sv.add_argument("--host", default="127.0.0.1")

    args = p.parse_args(argv)

    if args.cmd == "serve":
        from .dashboard_server import DashboardServer

        DashboardServer(args.reference, args.computed, host=args.host,
                        port=args.port).serve_forever()
        return 0

    if args.cmd == "dash_compare":
        from ..validation.analysis import load_dataset
        from .dashboard import compare_dashboard

        out = compare_dashboard(load_dataset(args.reference),
                                load_dataset(args.computed), args.out)
        print(f"wrote {out}")
        return 0

    if args.cmd == "plot":
        from ..validation.analysis import load_dataset
        from .plot_field import plot

        ds = load_dataset(args.file)
        a = ds[args.variable]
        if args.select_time is not None:
            a = a[args.select_time]
        b = None
        if args.diff_with:
            b = load_dataset(args.diff_with)[args.variable]
            if args.select_time is not None:
                b = b[args.select_time]
        out = plot(a, args.variable, diff_with=b,
                   reduce_dims=args.reduce_dim, out_png=args.out)
        print(f"wrote {out}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())

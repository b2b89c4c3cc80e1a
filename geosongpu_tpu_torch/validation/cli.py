"""Validation CLI of the port (geosongpu_tpu/validation/cli.py, the
reference's tcn/validation/cli.py:12-47):

    geosongpu-tpu-torch-validation validate REF COMPUTED VAR [-st time]
        [--hist PNG] [--rel_tol TOL]
    geosongpu-tpu-torch-validation serialbox DATDIR OUT [-l NX,NY]
        [-n input.nml] [-s savepoint] [-f auto|nc|npz]

`validate` exits 1 when the relative RMS is above --rel_tol.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="geosongpu-tpu-torch-validation")
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("validate")
    v.add_argument("reference")
    v.add_argument("computed")
    v.add_argument("variable")
    v.add_argument("-st", "--select_time", type=int, default=None)
    v.add_argument("--hist", default=None, help="write histogram PNG here")
    v.add_argument("--rel_tol", type=float, default=None,
                   help="exit nonzero if rel RMS above this")

    s = sub.add_parser("serialbox")
    s.add_argument("dat_dir")
    s.add_argument("out_dir")
    s.add_argument("-l", "--layout", default="1,1",
                   help="per-face rank layout NX,NY (x 6 tiles)")
    s.add_argument("-n", "--nml", default=None,
                   help="input.nml to read the layout from")
    s.add_argument("-s", "--savepoint", default=None)
    s.add_argument("-f", "--fmt", default="auto",
                   choices=["auto", "nc", "npz"])

    args = p.parse_args(argv)

    if args.cmd == "validate":
        from .analysis import analysis, load_dataset

        ref = load_dataset(args.reference)
        comp = load_dataset(args.computed)
        rep = analysis(ref, comp, args.variable, args.select_time, args.hist)
        print(rep)
        if args.rel_tol is not None and not (rep.rel_rms <= args.rel_tol):
            return 1
        return 0

    if args.cmd == "serialbox":
        from .serialbox_convert import convert

        lx, ly = (int(x) for x in args.layout.split(","))
        paths = convert(args.dat_dir, args.out_dir, layout=(lx, ly),
                        nml=args.nml, savepoint=args.savepoint,
                        fmt=args.fmt)
        for path in paths:
            print(f"wrote {path}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())

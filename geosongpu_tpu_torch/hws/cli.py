"""hws CLI (the port's copy of geosongpu_tpu/hws/cli.py):

    python -m geosongpu_tpu_torch.hws.cli server [--device cuda|cpu]
    python -m geosongpu_tpu_torch.hws.cli client start|tick|dump|stop
    python -m geosongpu_tpu_torch.hws.cli graph FILE [--out PNG]
    python -m geosongpu_tpu_torch.hws.cli envelop FILE [--data_range A B]

The server samples the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from . import constants as C


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="geosongpu-tpu-torch-hws")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server")
    s.add_argument("--rate", type=float, default=C.DEFAULT_SAMPLE_RATE_S)
    s.add_argument("--socket_dir", default=None)
    s.add_argument("--dump_dir", default=".")
    s.add_argument("--device", default="cuda",
                   help="the card to sample (cuda, cuda:N) or cpu")

    c = sub.add_parser("client")
    c.add_argument("order", choices=list(C.ORDERS))
    c.add_argument("--socket_dir", default=None)

    g = sub.add_parser("graph")
    g.add_argument("file")
    g.add_argument("--out", default=None)

    e = sub.add_parser("envelop")
    e.add_argument("file")
    e.add_argument("--data_range", type=float, nargs=2, default=None,
                   help="start/end seconds (over the samples' times, or "
                        "the sample rate where the dump has none)")

    args = p.parse_args(argv)

    if args.cmd == "server":
        import torch

        from .server import cli as server_cli

        if args.device.startswith("cuda") and not torch.cuda.is_available():
            p.error("CUDA is not available; pass --device cpu to sample "
                    "the host alone")
        server_cli(args.socket_dir, args.rate, args.dump_dir, args.device)
        return 0
    if args.cmd == "client":
        from .client import client_main

        reply = client_main(args.order, args.socket_dir)
        print(reply)
        return 0
    if args.cmd == "graph":
        from .graph import graph

        try:
            graph(args.file, args.out)
        except RuntimeError as err:
            print(f"{p.prog} graph: {err}", file=sys.stderr)
            return 1
        return 0
    if args.cmd == "envelop":
        from .analysis import energy_envelope, load_data

        data = load_data(args.file)
        start, end = 0, None
        if args.data_range:
            a, b = args.data_range
            if "t_s" in data:
                start, end = np.searchsorted(data["t_s"], [a, b])
            else:
                rate = float(data["rate_s"][0])
                start, end = int(a / rate), int(b / rate)
        rep = energy_envelope(data, int(start),
                              None if end is None else int(end))
        print(f"cpu: {rep.cpu_kwh*1e3:.3f} Wh, gpu: {rep.tpu_kwh*1e3:.3f} "
              f"Wh, total: {rep.total_kwh*1e3:.3f} Wh")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())

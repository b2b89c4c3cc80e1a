"""Interface-generator CLI (the port's counterpart of
geosongpu_tpu/interop/cli.py): an interface definition in, the generated
bridge sources and build fragment out.

    python -m geosongpu_tpu_torch.interop.cli \
        geosongpu_tpu_torch/interop/def_dycore.json OUT/
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="geosongpu-tpu-torch-interop")
    p.add_argument("definition",
                   help="interface definition (JSON; YAML needs pyyaml)")
    p.add_argument("target_dir", help="output directory")
    args = p.parse_args(argv)

    from .generator import Bridge

    bridge = Bridge.from_file(args.definition)
    files = bridge.write(args.target_dir)
    for name, path in sorted(files.items()):
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

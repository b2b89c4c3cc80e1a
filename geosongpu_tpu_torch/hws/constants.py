"""Hardware-sampler protocol constants and the spec table (the port's copy
of geosongpu_tpu/hws/constants.py).

The protocol is the original's: unix socket path, server orders, client
verbs, the 0.1 s default rate, the dump format.  The host CPU has no power
reading, so its power stays the original's envelope model (idle +
utilization x (tdp - idle)) over a host row of the table.  The card is not
modelled: the sampler reads its power, energy, utilization and memory
through NVML, and its row holds only what `nvidia-smi` reports.
"""
from __future__ import annotations

import os

SOCKET_DIRECTORY = "./sockets-runtime"
SOCKET_FILENAME = "hws"

# server orders
ORDER_START = "start"
ORDER_STOP = "stop"
ORDER_DUMP = "dump"
ORDER_TICK = "tick"
ORDERS = (ORDER_START, ORDER_STOP, ORDER_DUMP, ORDER_TICK)

# client verbs == orders (one-shot JSON messages)
CLIENT_CMDS = ORDERS

DEFAULT_SAMPLE_RATE_S = 0.1

DUMP_FORMAT = os.environ.get("HWSAMPLER_DUMP_FORMAT", "npz")  # npz | json

# spec table: name -> the row's numbers
HW_SPECS = {
    # host CPUs: the power envelope of the model
    "epyc_7402": {"idle_w": 60.0, "tdp_w": 180.0, "mem_mb": 0},
    "epyc_7763": {"idle_w": 80.0, "tdp_w": 280.0, "mem_mb": 0},
    "generic_host": {"idle_w": 40.0, "tdp_w": 150.0, "mem_mb": 0},
    # the card, as nvidia-smi reports it (power.limit, memory.total)
    "h100": {"power_limit_w": 700.0, "mem_mib": 81559},
}

CPU_SPEC = HW_SPECS[os.environ.get("HWS_HW_CPU", "generic_host")]
GPU_SPEC = HW_SPECS["h100"]


def socket_path(directory: str | None = None) -> str:
    d = directory or SOCKET_DIRECTORY
    return os.path.join(d, SOCKET_FILENAME)

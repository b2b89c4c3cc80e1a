"""One-shot sampling client (the port's copy of
geosongpu_tpu/hws/client.py)."""
from __future__ import annotations

import json
import socket

from . import constants as C


def client_main(order: str, socket_dir: str | None = None) -> dict:
    if order not in C.ORDERS:
        raise ValueError(f"unknown order {order}")
    path = C.socket_path(socket_dir)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(path)
        s.sendall(json.dumps({"order": order}).encode())
        s.shutdown(socket.SHUT_WR)
        raw = s.recv(65536)
    return json.loads(raw.decode()) if raw else {}

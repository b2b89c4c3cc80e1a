"""Rank meshes and the transport microbenchmark
(geosongpu_tpu/parallel/mesh.py).

* `make_mesh(mesh_cfg)`: the (face, y, x) grid of rank ids of a MeshConfig,
  the cubed-sphere analog of NX x NY x 6 rank layouts;
* `comm_microbench(group)`: ring-permute bandwidth and sum latency over a
  rank group (parallel/comm.py), the OSU latency/bandwidth analog, so that
  a scaling regression can be told apart as transport or compute.  On one
  rank the ring is a loopback copy.

The reference's `state_sharding` / `shard_state` are XLA's GSPMD
partitioner plan (XLA inserts the collectives of a global program); torch
has no such partitioner, and the port shards explicitly through
parallel/subtile.py instead.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import MeshConfig
from ..device import synchronize
from .comm import RankGroup


def make_mesh(cfg: MeshConfig, available: int) -> np.ndarray:
    """Rank ids [face, y, x] of the layout; raises when it needs more
    ranks than `available`."""
    n = cfg.n_devices
    if available < n:
        raise ValueError(f"mesh needs {n} ranks, have {available}")
    return np.arange(n).reshape(cfg.face, cfg.y, cfg.x)


def comm_microbench(group: RankGroup, sizes_bytes: Optional[List[int]] = None,
                    repeats: int = 20) -> Dict[str, list]:
    """Ring-permute bandwidth and sum latency across the group's ranks.

    Returns {"sizes": [...], "ppermute_gbps": [...], "psum_us": [...]}:
    bytes a rank sends per round over the round's time, and the time of a
    sum of 64 floats over all ranks.  Stacked ranks move every rank's
    message in one copy on one device, so their rate is the device's copy
    rate, not a link's."""
    n = group.size
    R = len(group.ranks)
    dev = group.device
    sizes = sizes_bytes or [2 ** k for k in range(12, 25, 2)]  # 4KB..16MB
    perm = [(i, (i + 1) % n) for i in range(n)]
    out: Dict[str, list] = {"sizes": [], "ppermute_gbps": [], "psum_us": []}
    for size in sizes:
        x = torch.zeros((R, max(size // 4, 1)), dtype=torch.float32,
                        device=dev)
        x = group.permute(x, perm)               # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            x = group.permute(x, perm)
        synchronize(dev)
        dt = (time.perf_counter() - t0) / repeats
        out["sizes"].append(size)
        out["ppermute_gbps"].append(size / dt / 1e9)

        y = torch.zeros((R, 64), dtype=torch.float32, device=dev)
        r = group.sum(y)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            r = group.sum(y)
        synchronize(dev)
        out["psum_us"].append((time.perf_counter() - t0) / repeats * 1e6)
    return out

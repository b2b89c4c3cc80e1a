"""Rank groups: the transport under the sharded fills.

The counterpart of `lax.axis_index` / `lax.ppermute` / `lax.psum` of the
JAX package's shard_map programs.  A group holds `size` ranks of one
layout; this process holds `ranks` of them.  Local arrays carry a leading
axis over the held ranks, so one program serves both forms:

* `StackedGroup(size, device)`: every rank lives in this process, on one
  device, stacked along the leading axis (the counterpart of the JAX
  tests' virtual host devices).  A round of a permutation is a re-index
  of that axis.
* `ProcessGroup(device)`: one rank per process over `torch.distributed`
  (gloo on the CPU, NCCL across cards).  A round is one
  `dist.batch_isend_irecv`.  The process group must be initialised
  first, e.g. by `init_from_env` from the variables that
  harness/launcher.py's `GPUJobConfig.launch_env` sets.

There is no fallback from one form to the other.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from ..spans import spanned

Perm = Tuple[Tuple[int, int], ...]


class RankGroup:
    """The interface: `size`, `ranks`, `device`, and three collectives on
    arrays whose leading axis runs over `ranks`."""

    size: int
    ranks: Tuple[int, ...]
    device: torch.device

    def permute(self, msgs: torch.Tensor, perm: Sequence[Tuple[int, int]]
                ) -> torch.Tensor:
        """One round of a partial permutation: rank d receives what rank s
        sent for every (s, d) in perm; a rank that receives nothing gets
        zeros (as ppermute gives)."""
        raise NotImplementedError

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over all ranks, the result on every held rank."""
        raise NotImplementedError

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """[len(ranks), ...] -> [size, ...], every rank's part, on every
        process."""
        raise NotImplementedError


class StackedGroup(RankGroup):
    """All `size` ranks in this process, on `device`."""

    def __init__(self, size: int, device):
        self.size = int(size)
        self.ranks = tuple(range(self.size))
        self.device = torch.device(device)
        self._src = {}

    def _sources(self, perm) -> torch.Tensor:
        """Per receiving rank the sending rank, `size` (a zero row) for a
        rank that receives nothing."""
        key = tuple(perm)
        hit = self._src.get(key)
        if hit is None:
            src = [self.size] * self.size
            for s, d in key:
                src[d] = s
            hit = torch.tensor(src, dtype=torch.int64, device=self.device)
            self._src[key] = hit
        return hit

    @spanned("exchange.permute")
    def permute(self, msgs, perm):
        padded = torch.cat([msgs, msgs.new_zeros((1,) + msgs.shape[1:])])
        return padded.index_select(0, self._sources(perm))

    def sum(self, x):
        return x.sum(dim=0, keepdim=True).expand_as(x).contiguous()

    def gather(self, local):
        return local


class ProcessGroup(RankGroup):
    """One rank per process over the initialised default process group."""

    def __init__(self, device=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "ProcessGroup needs an initialised torch.distributed process "
                "group (comm.init_from_env, or dist.init_process_group)")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)

    @spanned("exchange.permute")
    def permute(self, msgs, perm):
        me = self.rank
        send = msgs[0].contiguous()
        recv = None
        ops = []
        for s, d in perm:
            if s == me:
                ops.append(dist.P2POp(dist.isend, send, d))
            if d == me:
                recv = torch.empty_like(send)
                ops.append(dist.P2POp(dist.irecv, recv, s))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is None:
            recv = torch.zeros_like(send)
        return recv[None]

    def sum(self, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    def gather(self, local):
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts)


def init_from_env(backend: str = None) -> ProcessGroup:
    """Initialise the default process group from MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK (harness/launcher.py's launch_env) and return its
    ProcessGroup.  backend None: NCCL when a card is present, else gloo;
    with NCCL the process takes the card LOCAL_RANK."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    device = None
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return ProcessGroup(device)


def available_ranks(device) -> int:
    """Real ranks this host offers a layout: the process group's world size
    when one is initialised, else the visible cards on a card, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1

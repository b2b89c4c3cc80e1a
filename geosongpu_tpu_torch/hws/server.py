"""Hardware sampling server: an asyncio unix-socket service (the port's
form of geosongpu_tpu/hws/server.py: START spawns the sampling coroutine,
TICK marks an index, DUMP writes npz or JSON, STOP exits).

The dump keeps the original's keys, so each package's `load_data` reads
the other's files; on a card the `tpu_*` columns hold the GPU's NVML
readings:

  tpu_psu       W, nvmlDeviceGetPowerUsage (NVML's running average)
  tpu_mem_mb    nvmlDeviceGetMemoryInfo().used / 1e6
  tpu_busy      nvmlDeviceGetUtilizationRates().gpu / 100
  cpu_exe_utl   % busy of the host, from two reads of /proc/stat
  cpu_psu       W, the original's host model: idle + utl x (tdp - idle)
  host_mem_pct  (1 - MemAvailable / MemTotal) x 100, from /proc/meminfo
  t_s           time.perf_counter() of the sample, from the first sample
  energy_mj     nvmlDeviceGetTotalEnergyConsumption (card only)

and besides the series `device`, `gpu_name`, `gpu_uuid`, `power_limit_w`.
On a sampler asked for the CPU the three GPU columns are 0.0 and the dump
says device "cpu".  On a card nothing reads 0 in place of a failed read:
a missing library, handle or reading raises (hws/nvml.py).
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import constants as C
from .nvml import Device

FIELDS = ("tpu_psu", "tpu_mem_mb", "tpu_busy", "cpu_exe_utl", "cpu_psu",
          "host_mem_pct")


def cpu_times() -> Tuple[int, int]:
    """(busy, total) jiffies of all CPUs from /proc/stat: idle and iowait
    are idle; guest time is already inside user time."""
    with open("/proc/stat") as f:
        v = [int(x) for x in f.readline().split()[1:]]
    total = sum(v[:8])          # user .. steal
    return total - v[3] - v[4], total


def host_mem_pct() -> float:
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0])
    return (1.0 - info["MemAvailable"] / info["MemTotal"]) * 100.0


class Sampler:
    """Rows of FIELDS (and t_s, energy_mj) taken by sample_once, on the
    card `device` through NVML or, asked for "cpu", of the host alone.
    A card's NVML handle stays open until close()."""

    def __init__(self, rate_s: float = C.DEFAULT_SAMPLE_RATE_S,
                 device="cuda"):
        self.rate_s = rate_s
        self.device = torch.device(device)
        self.data: Dict[str, List[float]] = {k: [] for k in FIELDS}
        self.data["t_s"] = []
        self.ticks: List[int] = []
        self.running = False
        self.last_counter: Optional[Tuple[float, Optional[int]]] = None
        self._t0: Optional[float] = None
        self._cpu = cpu_times()
        self.gpu: Optional[Device] = None
        if self.device.type == "cuda":
            self.gpu = Device(self.device)
            self.data["energy_mj"] = []

    def close(self) -> None:
        if self.gpu is not None:
            self.gpu.close()

    def read_counter(self) -> Tuple[float, Optional[int]]:
        """(time.perf_counter(), the card's energy counter in mJ); None in
        place of the counter on the CPU."""
        return (time.perf_counter(),
                self.gpu.energy_mj() if self.gpu is not None else None)

    def _cpu_percent(self) -> float:
        busy, total = cpu_times()
        b0, t0 = self._cpu
        self._cpu = busy, total
        return 100.0 * (busy - b0) / (total - t0) if total > t0 else 0.0

    def sample_once(self) -> None:
        """One row; the clock and the energy counter are read first, so the
        row's time is the counter's."""
        t, energy = self.read_counter()
        if self._t0 is None:
            self._t0 = t
        self.last_counter = t, energy
        cpu = self._cpu_percent()
        cpu_psu = C.CPU_SPEC["idle_w"] + cpu / 100.0 * (
            C.CPU_SPEC["tdp_w"] - C.CPU_SPEC["idle_w"])
        if self.gpu is not None:
            gpu = (self.gpu.power_w(), self.gpu.memory_used_mb(),
                   self.gpu.busy())
            self.data["energy_mj"].append(energy)
        else:
            gpu = (0.0, 0.0, 0.0)
        row = gpu + (cpu, cpu_psu, host_mem_pct())
        for k, v in zip(FIELDS, row):
            self.data[k].append(v)
        self.data["t_s"].append(t - self._t0)

    async def run(self) -> None:
        self.running = True
        while self.running:
            self.sample_once()
            await asyncio.sleep(self.rate_s)

    def tick(self) -> None:
        self.ticks.append(len(self.data[FIELDS[0]]))

    def meta(self) -> dict:
        gpu = self.gpu
        return {"device": str(self.device),
                "gpu_name": gpu.name if gpu else "",
                "gpu_uuid": gpu.uuid if gpu else "",
                "power_limit_w": gpu.power_limit_w if gpu else 0.0}

    def dump(self, directory: str = ".") -> str:
        os.makedirs(directory, exist_ok=True)
        if C.DUMP_FORMAT == "json":
            path = os.path.join(directory, "hws_dump.json")
            with open(path, "w") as f:
                json.dump({"data": self.data, "ticks": self.ticks,
                           "rate_s": self.rate_s, **self.meta()}, f)
        else:
            path = os.path.join(directory, "hws_dump.npz")
            np.savez_compressed(
                path,
                ticks=np.asarray(self.ticks),
                rate_s=np.asarray([self.rate_s]),
                **{k: np.asarray(v) for k, v in self.meta().items()},
                **{k: np.asarray(v) for k, v in self.data.items()})
        return path


async def main(socket_dir: str | None = None,
               rate_s: float = C.DEFAULT_SAMPLE_RATE_S,
               dump_dir: str = ".", device="cuda") -> None:
    sampler = Sampler(rate_s, device)
    task: asyncio.Task | None = None
    stop_event = asyncio.Event()

    async def handle(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        nonlocal task
        raw = await reader.read(4096)
        try:
            order = json.loads(raw.decode()).get("order")
        except (UnicodeDecodeError, json.JSONDecodeError, AttributeError):
            order = None
        reply = {"status": "ok", "order": order}
        if task is not None and task.done() and not task.cancelled() \
                and task.exception() is not None:
            # the sampling stopped on a failed read: say so to every order
            reply = {"status": "sampler-failed", "order": order,
                     "error": repr(task.exception())}
            if order == C.ORDER_STOP:
                stop_event.set()
        elif order == C.ORDER_START:
            if task is None:
                task = asyncio.get_running_loop().create_task(sampler.run())
        elif order == C.ORDER_TICK:
            sampler.tick()
        elif order == C.ORDER_DUMP:
            reply["path"] = sampler.dump(dump_dir)
        elif order == C.ORDER_STOP:
            sampler.running = False
            stop_event.set()
        else:
            reply["status"] = "unknown-order"
        writer.write(json.dumps(reply).encode())
        await writer.drain()
        writer.close()

    sdir = socket_dir or C.SOCKET_DIRECTORY
    os.makedirs(sdir, exist_ok=True)
    path = C.socket_path(sdir)
    if os.path.exists(path):
        os.unlink(path)
    try:
        server = await asyncio.start_unix_server(handle, path=path)
        async with server:
            await stop_event.wait()
        if task is not None:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
    finally:
        sampler.close()
        if os.path.exists(path):
            os.unlink(path)


def cli(socket_dir: str | None = None,
        rate_s: float = C.DEFAULT_SAMPLE_RATE_S, dump_dir: str = ".",
        device="cuda") -> None:
    asyncio.run(main(socket_dir, rate_s, dump_dir, device))

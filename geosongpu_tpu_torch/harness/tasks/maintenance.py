"""Maintenance tasks (the port's counterpart of
geosongpu_tpu/harness/tasks/maintenance.py): CIClean empties the
workspace; CIInfo logs the dispatch's device and the disk, and records the
device as `ci_info.devices`.

One difference on purpose: the task lifecycle writes `ci_metadata` into the
workspace after run_action (task.py), so the reference's CIClean, which
wants the workspace empty, fails its own check whenever it is dispatched.
Here the check allows that one file.
"""
from __future__ import annotations

import os
import shutil

import torch

from ..environment import Environment
from ..progress import Progress
from ..registry import Registry
from ..task import TaskBase


@Registry.register
class CIClean(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        ws = env.CI_WORKSPACE
        if os.path.isdir(ws):
            shutil.rmtree(ws)
        os.makedirs(ws, exist_ok=True)

    def check(self, config, env: Environment) -> bool:
        ws = env.CI_WORKSPACE
        return os.path.isdir(ws) and set(os.listdir(ws)) <= {"ci_metadata"}


def describe_devices(device) -> str:
    """The CUDA cards, by count and name, when `device` is a card (raises
    without CUDA); "cpu" for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           "available")
    n = torch.cuda.device_count()
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    return f"{n} x cuda: " + ", ".join(names)


@Registry.register
class CIInfo(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        ws = env.CI_WORKSPACE
        usage = shutil.disk_usage(ws if os.path.isdir(ws) else "/")
        devices = describe_devices(env.get("device", "cuda"))
        Progress.log(f"devices: {devices}")
        Progress.log(
            f"disk: {usage.used / 1e9:.1f} / {usage.total / 1e9:.1f} GB used")
        env.set("ci_info.devices", devices)

    def check(self, config, env: Environment) -> bool:
        return env.exists("ci_info.devices")

"""The card's energy counter through NVML (`libnvidia-ml.so.1`).

Frozen copy, at commit f902e7ad95fb, of the reads of
geosongpu_tpu_torch/hws/nvml.py that the benchmark takes: the card found by
torch's UUID, its name checked against torch's, its total energy since the
NVIDIA kernel module loaded (mJ) and its enforced power limit.  A call that
returns non-zero raises with NVML's own message: a reading the card cannot
give is an error, never a zero.
"""
from __future__ import annotations

import ctypes

import torch

_HANDLE = ctypes.c_void_p
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetHandleByUUID": [ctypes.c_char_p, ctypes.POINTER(_HANDLE)],
    "nvmlDeviceGetName": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetTotalEnergyConsumption": [
        _HANDLE, ctypes.POINTER(ctypes.c_ulonglong)],
    "nvmlDeviceGetEnforcedPowerLimit": [_HANDLE,
                                        ctypes.POINTER(ctypes.c_uint)],
}


class NVMLError(RuntimeError):
    pass


class Card:
    """The NVML handle of torch's CUDA device `index`; close() releases
    NVML."""

    def __init__(self, index: int = 0):
        try:
            self._lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as e:
            raise NVMLError(f"cannot load NVML: {e}") from e
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(self._lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        self._lib.nvmlErrorString.argtypes = [ctypes.c_int]
        self._lib.nvmlErrorString.restype = ctypes.c_char_p
        self._call("nvmlInit_v2")
        try:
            uuid = f"GPU-{torch.cuda.get_device_properties(index).uuid}"
            self.handle = _HANDLE()
            self._call("nvmlDeviceGetHandleByUUID", uuid.encode(),
                       ctypes.byref(self.handle))
            buf = ctypes.create_string_buffer(96)
            self._call("nvmlDeviceGetName", self.handle, buf, len(buf))
            self.name = buf.value.decode()
            if self.name != torch.cuda.get_device_name(index):
                raise NVMLError(f"NVML names {uuid} {self.name!r}, torch "
                                f"{torch.cuda.get_device_name(index)!r}")
            v = ctypes.c_uint()
            self._call("nvmlDeviceGetEnforcedPowerLimit", self.handle,
                       ctypes.byref(v))
            self.power_limit_w = v.value / 1e3
        except BaseException:
            self._call("nvmlShutdown")
            raise

    def _call(self, fn: str, *args) -> None:
        rc = getattr(self._lib, fn)(*args)
        if rc != 0:
            msg = self._lib.nvmlErrorString(rc)
            raise NVMLError(f"{fn}: {msg.decode() if msg else '?'} "
                            f"(nvmlReturn {rc})")

    def energy_j(self) -> float:
        """Energy used since the NVIDIA kernel module loaded, in J."""
        v = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   ctypes.byref(v))
        return v.value / 1e3

    def close(self) -> None:
        self._call("nvmlShutdown")

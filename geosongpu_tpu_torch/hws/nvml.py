"""A small ctypes binding of NVML (`libnvidia-ml.so.1`, installed with the
card's NVIDIA software): the reads the hardware sampler takes from a card.

Every call that returns non-zero raises NVMLError with NVML's own message
(`nvmlErrorString`), NVML_ERROR_NOT_SUPPORTED included: a reading the card
cannot give is an error, never a zero.

NVML counts the physical GPUs, torch the ones CUDA_VISIBLE_DEVICES leaves
visible, so `Device` finds torch's device by its UUID and checks that both
libraries give it the same name.
"""
from __future__ import annotations

import ctypes

import torch

LIBRARY = "libnvidia-ml.so.1"


class NVMLError(RuntimeError):
    pass


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


_HANDLE = ctypes.c_void_p
# function -> argument types; every one returns an nvmlReturn_t
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlSystemGetDriverVersion": [ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetHandleByUUID": [ctypes.c_char_p, ctypes.POINTER(_HANDLE)],
    "nvmlDeviceGetName": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetPowerUsage": [_HANDLE, ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetTotalEnergyConsumption": [
        _HANDLE, ctypes.POINTER(ctypes.c_ulonglong)],
    "nvmlDeviceGetUtilizationRates": [_HANDLE, ctypes.POINTER(_Utilization)],
    "nvmlDeviceGetMemoryInfo": [_HANDLE, ctypes.POINTER(_Memory)],
    "nvmlDeviceGetEnforcedPowerLimit": [_HANDLE,
                                        ctypes.POINTER(ctypes.c_uint)],
}


class NVML:
    """The library, initialised while the object is open (NVML counts
    nested initialisations, so several may be open at once)."""

    def __init__(self, library: str | None = None):
        name = library or LIBRARY
        try:
            self._lib = ctypes.CDLL(name)
        except OSError as e:
            raise NVMLError(f"cannot load NVML ({name}): {e}") from e
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(self._lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        self._lib.nvmlErrorString.argtypes = [ctypes.c_int]
        self._lib.nvmlErrorString.restype = ctypes.c_char_p
        self._call("nvmlInit_v2")
        self._open = True

    def _call(self, fn: str, *args) -> None:
        rc = getattr(self._lib, fn)(*args)
        if rc != 0:
            msg = self._lib.nvmlErrorString(rc)
            raise NVMLError(f"{fn}: {msg.decode() if msg else '?'} "
                            f"(nvmlReturn {rc})")

    def close(self) -> None:
        if self._open:
            self._open = False
            self._call("nvmlShutdown")

    def __enter__(self) -> "NVML":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def driver_version(self) -> str:
        buf = ctypes.create_string_buffer(96)
        self._call("nvmlSystemGetDriverVersion", buf, len(buf))
        return buf.value.decode()

    def handle(self, uuid: str) -> ctypes.c_void_p:
        h = _HANDLE()
        self._call("nvmlDeviceGetHandleByUUID", uuid.encode(),
                   ctypes.byref(h))
        return h

    def name(self, h) -> str:
        buf = ctypes.create_string_buffer(96)
        self._call("nvmlDeviceGetName", h, buf, len(buf))
        return buf.value.decode()

    def power_mw(self, h) -> int:
        """The board's power draw in mW (NVML's running average over about
        a second on recent cards)."""
        v = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerUsage", h, ctypes.byref(v))
        return v.value

    def energy_mj(self, h) -> int:
        """Energy used since the NVIDIA kernel module was loaded, in mJ."""
        v = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", h, ctypes.byref(v))
        return v.value

    def utilization_pct(self, h) -> int:
        """The share of the last sample period (1/6 s to 1 s) in which a
        kernel ran, in percent."""
        u = _Utilization()
        self._call("nvmlDeviceGetUtilizationRates", h, ctypes.byref(u))
        return u.gpu

    def memory_used_bytes(self, h) -> int:
        m = _Memory()
        self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(m))
        return m.used

    def power_limit_mw(self, h) -> int:
        v = ctypes.c_uint()
        self._call("nvmlDeviceGetEnforcedPowerLimit", h, ctypes.byref(v))
        return v.value


def torch_uuid(index: int) -> str:
    """torch's CUDA device `index` as NVML names it: GPU-xxxxxxxx-..."""
    return f"GPU-{torch.cuda.get_device_properties(index).uuid}"


class Device:
    """The NVML handle of a torch CUDA device, with its readings.  Opens
    its own NVML; close() (or the with block) releases it."""

    def __init__(self, device, library: str | None = None):
        self.nvml = NVML(library)
        try:
            device = torch.device(device)
            if device.type != "cuda":
                raise NVMLError(f"{device} is not a CUDA device")
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
            self.uuid = torch_uuid(index)
            self.handle = self.nvml.handle(self.uuid)
            self.name = self.nvml.name(self.handle)
            torch_name = torch.cuda.get_device_name(index)
            if self.name != torch_name:
                raise NVMLError(f"NVML names {self.uuid} {self.name!r}, "
                                f"torch names cuda:{index} {torch_name!r}")
            self.power_limit_w = self.nvml.power_limit_mw(self.handle) / 1e3
        except BaseException:
            self.nvml.close()
            raise

    def close(self) -> None:
        self.nvml.close()

    def __enter__(self) -> "Device":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def power_w(self) -> float:
        return self.nvml.power_mw(self.handle) / 1e3

    def energy_mj(self) -> int:
        return self.nvml.energy_mj(self.handle)

    def busy(self) -> float:
        return self.nvml.utilization_pct(self.handle) / 100.0

    def memory_used_mb(self) -> float:
        return self.nvml.memory_used_bytes(self.handle) / 1e6

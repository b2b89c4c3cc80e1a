"""Banded vertical remap as a hand-written CUDA kernel (csrc/remap_banded.cu).

Counterpart of geosongpu_tpu/ops/pallas/remap.py.  The library is compiled
with nvcc for sm_90a on first use, from the package's own sources, into
`geosongpu_tpu_torch/_build/` (rebuilt when the source's hash changes), and
bound with ctypes through a plain C entry point.  Nothing is compiled or
loaded at import time.

`remap_banded` is the wrapper: for tensors on the CPU it runs the plain
PyTorch version (ops/remap.py::remap_fields_banded); for CUDA tensors it
launches the kernel or raises.  `remap_banded.launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from ..remap import _check_kord, remap_fields_banded

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "remap_banded.cu"
BUILD_DIR = _PKG / "_build"
MAX_FIELDS = 4  # kMaxFields in the source
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class KernelLibrary:
    fn: object            # the ctypes function remap_banded_f32
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    build_log: str        # nvcc/ptxas output of the build


_LIBRARY = None  # the loaded KernelLibrary, one per process


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then the toolkit's default place."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("remap_banded: nvcc not found (set CUDA_HOME or put "
                       "nvcc on PATH); the CUDA kernel cannot be built")


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library.  Raises when there is
    no CUDA device, no nvcc, or the build or load fails: there is no
    fallback."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    if not torch.cuda.is_available():
        raise RuntimeError("remap_banded: no CUDA device is available")
    nvcc = find_nvcc()
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"remap_banded_{digest}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"remap_banded_{digest}.{os.getpid()}.tmp.so"
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"remap_banded: nvcc failed with code "
                               f"{res.returncode}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.remap_banded_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIBRARY = KernelLibrary(fn=fn, path=so, build_seconds=seconds,
                             build_log=log)
    return _LIBRARY


def _check_inputs(qs, pe1, pe2):
    if not 1 <= len(qs) <= MAX_FIELDS:
        raise ValueError(f"remap_banded takes 1..{MAX_FIELDS} fields, "
                         f"got {len(qs)}")
    shape = qs[0].shape
    K = shape[-1]
    if K < 2:
        raise ValueError("remap_banded needs at least 2 layers")
    want_pe = shape[:-1] + (K + 1,)
    dev = qs[0].device
    for name, t, want in ([(f"qs[{i}]", q, shape) for i, q in enumerate(qs)]
                          + [("pe1", pe1, want_pe), ("pe2", pe2, want_pe)]):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}, expected torch.float32")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def remap_banded(qs, pe1: torch.Tensor, pe2: torch.Tensor, kord: int = 8,
                 band: int = 10):
    """Banded kord-8 remap of 1..4 fields sharing (pe1, pe2).
    qs: list of [..., K]; pe1/pe2: [..., K+1].  Returns a list."""
    _check_kord(kord)
    dev = qs[0].device
    if dev.type == "cpu":
        return remap_fields_banded(qs, pe1, pe2, kord, band)
    if dev.type != "cuda":
        raise ValueError(f"remap_banded: unsupported device {dev}")
    _check_inputs(qs, pe1, pe2)
    lib = load_library()
    K = qs[0].shape[-1]
    ncol = qs[0].numel() // K
    band = min(band, K - 1)
    outs = [torch.empty(q.shape, dtype=q.dtype, device=dev) for q in qs]
    n = len(qs)
    q_ptrs = (ctypes.c_void_p * n)(*[q.data_ptr() for q in qs])
    o_ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.fn(q_ptrs, o_ptrs, n, pe1.data_ptr(), pe2.data_ptr(), ncol, K,
                band, index, stream)
    if rc != 0:
        raise RuntimeError(f"remap_banded: kernel launch failed with CUDA "
                           f"error {rc}")
    remap_banded.launches += 1
    return outs


remap_banded.launches = 0

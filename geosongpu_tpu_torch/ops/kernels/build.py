"""Build and load the port's CUDA kernel library.

Every `csrc/*.cu` of the package is compiled by nvcc for sm_90a, one nvcc
process per source, all started together, and the objects are linked into
one shared library with a plain C interface, bound with ctypes.  The build
goes to `geosongpu_tpu_torch/_build/<hash>/`, keyed by a hash over every
`.cu` and `.cuh` source and the flags, at first use; nothing is compiled
or loaded at import time.  `check_tensors` and `launch` are what every
wrapper shares: the input checks and the call of a C entry on the current
stream.

The kernels build with `--fmad=false`: their arithmetic then matches the
plain PyTorch versions operation by operation, and a hord-8 limiter branch
cannot flip on an FMA rounding.  Contracting to FMAs is a later choice.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from ...spans import spanned

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "--fmad=false",
                              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    build_log: str        # nvcc/ptxas output of the build
    _fns: dict = field(default_factory=dict)

    def function(self, name: str, argtypes, restype=ctypes.c_int):
        """The C entry `name` with its argument types set (once)."""
        fn = self._fns.get(name)
        if fn is None:
            fn = getattr(self.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            self._fns[name] = fn
        return fn


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
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    cus, cuhs = sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command, wait for all; (return codes, outputs)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], outs


def _build(nvcc: str, out_dir: Path) -> str:
    cus, _ = sources()
    tmp = out_dir.with_name(f"{out_dir.name}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    objs = [tmp / f"{p.stem}.o" for p in cus]
    rcs, outs = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o",
                           str(obj)] for src, obj in zip(cus, objs)])
    log = "".join(f"== {src.name}\n{out}" for src, out in zip(cus, outs))
    bad = [src.name for src, rc in zip(cus, rcs) if rc != 0]
    if bad:
        raise RuntimeError(f"nvcc failed on {bad}:\n{log}")
    so = tmp / "libgeosongpu_kernels.so"
    rcs, outs = _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(so),
                           *map(str, objs)]])
    log += f"== link\n{outs[0]}"
    if rcs[0] != 0:
        raise RuntimeError(f"nvcc link failed:\n{log}")
    (tmp / "build.log").write_text(log)
    try:
        os.replace(tmp, out_dir)
    except OSError:   # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return log


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library.  Raises when there is
    no CUDA device, no nvcc, or the build or load fails: there is no
    fallback."""
    if _LIBRARY is not None:
        return _LIBRARY
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is "
                           "available")
    return _load()


@spanned("setup.library")
def _load() -> KernelLibrary:
    """The library of the sources' hash: built first where the build
    directory does not hold it yet, then loaded."""
    global _LIBRARY
    nvcc = find_nvcc()
    out_dir = BUILD_DIR / _digest()
    so = out_dir / "libgeosongpu_kernels.so"
    seconds, log = 0.0, ""
    if not so.exists():
        t0 = time.perf_counter()
        log = _build(nvcc, out_dir)
        seconds = time.perf_counter() - t0
    _LIBRARY = KernelLibrary(lib=ctypes.CDLL(str(so)), path=so,
                             build_seconds=seconds, build_log=log)
    return _LIBRARY


_CTYPES = {"P": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "f": ctypes.c_float}


def device_of(name: str, t) -> torch.device:
    """The device of the tensor that decides a wrapper's route (CPU: the
    plain version, CUDA: the kernel)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def check_tensors(kernel: str, dev, named_shapes) -> None:
    """Raise unless every (name, tensor, shape) is a contiguous float32
    tensor of that shape on `dev`."""
    for name, t, shape in named_shapes:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{kernel}: {name} is not a tensor")
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"{dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected "
                            "torch.float32")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)},"
                             f" expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def launch(kernel: str, spec: str, dev, args) -> None:
    """Call C entry `<kernel>_f32` with `args` (spec: one of P/i/l/f per
    argument) plus the device index and current stream; raise on a CUDA
    error."""
    fn = load_library().function(f"{kernel}_f32",
                                 [_CTYPES[c] for c in spec + "iP"])
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    rc = fn(*args, index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{rc}")

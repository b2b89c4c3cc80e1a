"""Banded vertical remap as a hand-written CUDA kernel (csrc/remap_banded.cu).

Counterpart of geosongpu_tpu/ops/pallas/remap.py.  The kernel is part of
the package's one CUDA library (ops/kernels/build.py: nvcc for sm_90a on
first use, ctypes binding through a plain C entry point).  Nothing is
compiled or loaded at import time.

`remap_banded` is the wrapper: for tensors on the CPU it runs the plain
PyTorch version (ops/remap.py::remap_fields_banded); for CUDA tensors it
launches the kernel or raises.  It takes any number of fields and hands
them over in groups of up to MAX_FIELDS sharing (pe1, pe2), one launch (or
one plain call) per group.  `remap_banded.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ...spans import spanned
from ..remap import _check_kord, remap_fields_banded
from .build import load_library

MAX_FIELDS = 4  # kMaxFields in the source: the fields of one launch
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def _check_inputs(qs, pe1, pe2):
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


@spanned("kernel.remap_banded")
def remap_banded(qs, pe1: torch.Tensor, pe2: torch.Tensor, kord: int = 8,
                 band: int = 10):
    """Banded kord-8 remap of one or more fields sharing (pe1, pe2).
    qs: list of [..., K]; pe1/pe2: [..., K+1].  Returns a list."""
    _check_kord(kord)
    if not qs:
        raise ValueError("remap_banded takes at least one field")
    groups = [qs[n:n + MAX_FIELDS] for n in range(0, len(qs), MAX_FIELDS)]
    dev = qs[0].device
    if dev.type == "cpu":
        return [o for g in groups
                for o in remap_fields_banded(g, pe1, pe2, kord, band)]
    if dev.type != "cuda":
        raise ValueError(f"remap_banded: unsupported device {dev}")
    _check_inputs(qs, pe1, pe2)
    fn = load_library().function("remap_banded_f32", _ARGTYPES)
    K = qs[0].shape[-1]
    ncol = qs[0].numel() // K
    band = min(band, K - 1)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for g in groups:
        o = [torch.empty(q.shape, dtype=q.dtype, device=dev) for q in g]
        n = len(g)
        q_ptrs = (ctypes.c_void_p * n)(*[q.data_ptr() for q in g])
        o_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in o])
        rc = fn(q_ptrs, o_ptrs, n, pe1.data_ptr(), pe2.data_ptr(), ncol, K,
                band, index, stream)
        if rc != 0:
            raise RuntimeError(f"remap_banded: kernel launch failed with "
                               f"CUDA error {rc}")
        remap_banded.launches += 1
        outs += o
    return outs


remap_banded.launches = 0

"""Column-physics kernels as hand-written CUDA: fill_q2_zero
(csrc/fill_q2_zero.cu) and aer_activation, moist_rad_coup, cup_gf_sh
(csrc/column_kernels.cu).  fill_q2_zero has a second form,
`fill_q2_zero_tracers`, which fills the first n tracers of the model
state's tracer array [..., K, nq] in one launch of the same kernel and
counts on `fill_q2_zero.launches`.

Counterparts of geosongpu_tpu/ops/pallas/columns.py: `fill_q2_zero` of
fill_q2_zero_pallas (:99), and the three others of the generic fuser
column_kernel_call (:30) with the three bodies the physics gate gives it.
A fuser of Python bodies has no CUDA counterpart short of a code
generator, so each body is a kernel written from its formula: a second
source beside the primary in physics/standalone.py.

For each kernel: the wrapper, its `launches` counter and its plain PyTorch
version `<name>_plain` with the wrapper's signature, which is the primary
(the kernels keep the primaries' operation order).  A wrapper given CPU
tensors runs the plain version.  Given CUDA tensors it checks that every
input is a contiguous float32 [..., K] tensor of one shape on one device,
flattens the leading axes to columns, allocates the outputs with
torch.empty, launches the C entry on the current stream and raises on a
CUDA error; a strided view such as `state.q[..., 0]` is refused (the
tracers of a state go to `fill_q2_zero_tracers` whole).  Nothing is
compiled or loaded at import time.
"""
from __future__ import annotations

import math

import torch

from ...physics import standalone as primary
from ...physics.thermo import CP_AIR, EPS, RDGAS
from ...spans import spanned
from .build import check_tensors, device_of, launch


def column_extents(kernel: str, named):
    """Check the CUDA inputs `named` = [(name, tensor), ...] of a column
    kernel against the first one's shape and device; -> (device, shape,
    ncol, K)."""
    first = named[0][1]
    shape = tuple(first.shape)
    if len(shape) < 1 or shape[-1] < 1:
        raise ValueError(f"{kernel}: {named[0][0]} must be [..., K] with "
                         f"K >= 1, got shape {shape}")
    check_tensors(kernel, first.device, [(n, t, shape) for n, t in named])
    return first.device, shape, first.numel() // shape[-1], shape[-1]


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


# the plain versions: the primaries, whose operation order the kernels keep
fill_q2_zero_plain = primary.fill_q2_zero
aer_activation_plain = primary.aer_activation
moist_rad_coup_plain = primary.moist_rad_coup
cup_gf_sh_plain = primary.cup_gf_sh


def fill_q2_zero_tracers_plain(q, delp, n: int):
    """fill_q2_zero_plain of each of the first n tracers of q [..., K, nq]
    -> n tensors [..., K]."""
    return tuple(fill_q2_zero_plain(q[..., t], delp) for t in range(n))


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

@spanned("kernel.fill_q2_zero")
def fill_q2_zero(q, delp):
    """Top-down borrowing of negative tracer mass from the layer below,
    the bottom layer clipped -> q' [..., K]."""
    if device_of("fill_q2_zero: q", q).type == "cpu":
        return fill_q2_zero_plain(q, delp)
    dev, shape, ncol, K = column_extents("fill_q2_zero",
                                         [("q", q), ("delp", delp)])
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    launch("fill_q2_zero", "liii" + "PPP", dev,
           [ncol, K, 1, 1, *_ptrs(q, delp, out)])
    fill_q2_zero.launches += 1
    return out


@spanned("kernel.fill_q2_zero")
def fill_q2_zero_tracers(q, delp, n: int):
    """fill_q2_zero of the first `n` tracers of a tracer array q [..., K,
    nq], as the model state holds it, in one launch: no tracer slice is
    copied and delp is read once -> n contiguous tensors [..., K]."""
    if device_of("fill_q2_zero_tracers: q", q).type == "cpu":
        return fill_q2_zero_tracers_plain(q, delp, n)
    dev, shape, ncol, K = column_extents("fill_q2_zero_tracers",
                                         [("delp", delp)])
    if q.dim() != len(shape) + 1:
        raise ValueError(f"fill_q2_zero_tracers: q must be [..., K, nq] "
                         f"over delp's {shape}, got {tuple(q.shape)}")
    nq = q.shape[-1]
    check_tensors("fill_q2_zero_tracers", dev, [("q", q, shape + (nq,))])
    if not (isinstance(n, int) and 1 <= n <= nq):
        raise ValueError(f"fill_q2_zero_tracers: n must be an int in 1.."
                         f"{nq}, got {n!r}")
    out = torch.empty((n,) + shape, dtype=torch.float32, device=dev)
    launch("fill_q2_zero", "liii" + "PPP", dev,
           [ncol, K, nq, n, *_ptrs(q, delp, out)])
    fill_q2_zero.launches += 1
    return tuple(out.unbind(0))


@spanned("kernel.aer_activation")
def aer_activation(num_aer, w, t, p, sigma_g: float = 2.0,
                   s_crit0: float = 0.003):
    """Activated droplet number -> [..., K].  t and p belong to the
    kernel's signature and are checked, but no term of the formula reads
    them."""
    if device_of("aer_activation: num_aer", num_aer).type == "cpu":
        return aer_activation_plain(num_aer, w, t, p, sigma_g, s_crit0)
    dev, shape, ncol, K = column_extents(
        "aer_activation", [("num_aer", num_aer), ("w", w), ("t", t),
                           ("p", p)])
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    launch("aer_activation", "li" + "PP" + "ff" + "P", dev,
           [ncol, K, *_ptrs(num_aer, w), s_crit0,
            math.sqrt(2.0) * 1.5 * math.log(sigma_g), out.data_ptr()])
    aer_activation.launches += 1
    return out


@spanned("kernel.moist_rad_coup")
def moist_rad_coup(ql, qi, p, t):
    """Cloud fraction, effective radii and condensate for the radiation
    coupling -> dict of [..., K].  p is checked but not read."""
    if device_of("moist_rad_coup: ql", ql).type == "cpu":
        return moist_rad_coup_plain(ql, qi, p, t)
    dev, shape, ncol, K = column_extents(
        "moist_rad_coup", [("ql", ql), ("qi", qi), ("p", p), ("t", t)])
    outs = [torch.empty(shape, dtype=torch.float32, device=dev)
            for _ in range(4)]
    launch("moist_rad_coup", "li" + "PPP" + "PPPP", dev,
           [ncol, K, *_ptrs(ql, qi, t, *outs)])
    moist_rad_coup.launches += 1
    return dict(zip(("cloud_fraction", "re_liquid", "re_ice", "condensate"),
                    outs))


@spanned("kernel.cup_gf_sh")
def cup_gf_sh(t, qv, p, delp, dt: float):
    """Shallow-convective mixing of t and qv across unstable interfaces
    -> (t', qv')."""
    if device_of("cup_gf_sh: t", t).type == "cpu":
        return cup_gf_sh_plain(t, qv, p, delp, dt)
    dev, shape, ncol, K = column_extents(
        "cup_gf_sh", [("t", t), ("qv", qv), ("p", p), ("delp", delp)])
    outs = (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev))
    launch("cup_gf_sh", "li" + "PPPP" + "fff" + "PP", dev,
           [ncol, K, *_ptrs(t, qv, p, delp),
            (1.0 - math.exp(-dt / 10800.0)) * 0.5, 1.0 / EPS - 1.0,
            RDGAS / CP_AIR, *_ptrs(*outs)])
    cup_gf_sh.launches += 1
    return outs


KERNELS = (fill_q2_zero, aer_activation, moist_rad_coup, cup_gf_sh)
for _k in KERNELS:
    _k.launches = 0

"""The nonhydrostatic vertical solve's per-column arithmetic on the CPU.

csrc/nh_vertical_columns.cuh holds what the kernel nh_vertical_solve
(csrc/nh_vertical_solve.cu) computes in a column: the gas-law anchor, the
linearisation of a layer, the coefficients of an interface, the two Thomas
sweeps and z*.  It includes nothing of CUDA, so g++ builds it (with FMA
contraction off, as nvcc builds the kernel with --fmad=false) into a small
library that walks seeded columns one by one with those functions, in the
kernel's order, and the result is held against the plain version
`dsw.nh_vertical_solve_plain` on the CPU.

The gates are relative to max|plain|, not 0.0: glibc's powf and logf differ
from PyTorch's vectorised CPU pow and log by an ulp in a few draws, and on
the CPU the plain version's pe / 1e5 is a true division where the kernel,
like PyTorch on the card, multiplies by 1 / P00.  delz keeps those ulps
(1e-5; measured <= 3.1e-7); w, the solution of a system whose right-hand
side is a difference of pressures that cancel to ~1e-3 of their terms,
carries them ~1e3 times over (1e-4 with the 1e-4 m/s floor of
tests/test_torch_nh_solve.py; measured <= 2.7e-5, and noise alone at
rest).  The thin layers of the clamp case (1 and 2 Pa) take pkz from a
difference of nearly equal pk, which one ulp of pk moves by ~1e-2
(measured: w 1.0e-2, delz 1.2e-5).  A lag of one interface in either
sweep, a stale z* or a swapped coefficient moves w by 0.2-1.1 of max|w|
and delz by 4.5e-3 or more in every case with more than one unknown.  The
card's gate, the kernel equal to its plain version in every element, is
in tests/test_torch_cuda.py.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu_torch.ops.kernels import dsw  # noqa: E402
from test_torch_nh_solve import DT, PTOP, _case, _columns  # noqa: E402

CSRC = Path(dsw.__file__).resolve().parents[2] / "csrc"
# case -> (w: relative gate, floor in m/s; delz: relative gate)
GATES = {"clamp": (5e-2, 1e-4, 1e-4)}
DEFAULT_GATES = (1e-4, 1e-4, 1e-5)

# the kernel's phases, column by column, on the header's functions
COLUMNS_CPP = r"""
#include <vector>

#include "nh_vertical_columns.cuh"

extern "C" void nh_solve_columns(long long ncol, int K, const float* w,
                                 const float* delz, const float* pt,
                                 const float* delp, float dt, float ptop,
                                 float p00, float kappa, float gamma,
                                 float grav, float rdgas, float* w_out,
                                 float* delz_out) {
  const int M = K - 1;
  std::vector<float> pe(K), pk(K), ln(K), p0(K), ph(K), z(K), x(M);
  std::vector<nhv::Row> q(M);
  std::vector<nhv::Layer> lay(K);
  const float rp00 = 1.0f / p00;
  const float pk_top = nhv::interface_pk(ptop, rp00, kappa);
  const float ln_top = logf(ptop);
  for (long long col = 0; col < ncol; ++col) {
    const long long o = col * K;
    nhv::column_pe(delp + o, pe.data(), K, ptop);
    for (int k = 0; k < K; ++k) {
      pk[k] = nhv::interface_pk(pe[k], rp00, kappa);
      ln[k] = logf(pe[k]);
    }
    for (int k = 0; k < K; ++k) {
      const nhv::Anchor an = nhv::anchor(
          k ? pe[k - 1] : ptop, pe[k], k ? pk[k - 1] : pk_top, pk[k],
          k ? ln[k - 1] : ln_top, ln[k], pt[o + k], delp[o + k],
          delz[o + k], kappa, grav, rdgas);
      p0[k] = an.p0;
      ph[k] = an.ph;
      z[k] = delz[o + k];
    }
    for (int it = 0; it < 2; ++it) {
      for (int k = 0; k < K; ++k)
        lay[k] = nhv::linearise(z[k], p0[k], ph[k], delz[o + k],
                                delp[o + k], gamma, grav, it == 0);
      for (int j = 0; j < M; ++j)
        q[j] = nhv::coefficients(lay[j], lay[j + 1],
                                 0.5f * (w[o + j] + w[o + j + 1]), dt);
      nhv::thomas_forward(q.data(), M);
      nhv::thomas_backward(q.data(), x.data(), M);
      for (int k = 0; k < K; ++k)
        z[k] = nhv::z_star(delz[o + k], k > 0 ? x[k - 1] : 0.0f,
                           k < M ? x[k] : 0.0f, dt);
    }
    for (int k = 0; k < K; ++k) {
      const float top = k > 0 ? x[k - 1] : 0.0f;
      const float bot = k < M ? x[k] : 0.0f;
      delz_out[o + k] = nhv::clamp1(z[k]);
      w_out[o + k] = 0.5f * (top + bot);
    }
  }
}
"""


@pytest.fixture(scope="module")
def columns_lib(tmp_path_factory):
    """The header built by g++ -O2 -ffp-contract=off, with the walk above."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("nh_columns")
    src = out / "nh_columns.cpp"
    src.write_text(COLUMNS_CPP)
    so = out / "libnh_columns.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fPIC",
                    "-shared", "-I", str(CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.nh_solve_columns
    fn.argtypes = ([ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p] * 2)
    fn.restype = None
    return fn


def _host_solve(fn, w, delz, pt, delp):
    ins = [np.ascontiguousarray(a, np.float32) for a in (w, delz, pt, delp)]
    K = ins[0].shape[-1]
    outs = [np.empty_like(ins[0]) for _ in range(2)]
    fn(ins[0].size // K, K, *[a.ctypes.data for a in ins], DT, PTOP, dsw.P00,
       dsw.KAPPA, dsw.GAMMA, dsw.GRAV, dsw.RDGAS,
       *[o.ctypes.data for o in outs])
    return outs


HOST_CASES = ["K2", "odd K7", "K8", "K72", "clamp", "balanced"]


def _host_case(name):
    return _columns(72, seed=6) if name == "K72" else _case(name)


@pytest.mark.parametrize("case", HOST_CASES)
def test_header_arithmetic_matches_the_plain_version(columns_lib, case):
    arrays = _host_case(case)
    got = _host_solve(columns_lib, *arrays)
    want = dsw.nh_vertical_solve_plain(*map(torch.from_numpy, arrays), DT,
                                       PTOP)
    w_rel, w_atol, z_rel = GATES.get(case, DEFAULT_GATES)
    for name, g, p, rel, atol in (("w", got[0], want[0], w_rel, w_atol),
                                  ("delz", got[1], want[1], z_rel, 0.0)):
        p = p.numpy()
        assert g.shape == p.shape and np.isfinite(g).all(), (case, name)
        scale = float(np.abs(p).max())
        d = float(np.abs(g - p).max())
        assert d <= max(rel * scale, atol), (case, name, d, scale)
    if case == "clamp":
        # the thin layers leave the solve at the 1 m floor, as in plain
        assert int((got[1] == 1.0).sum()) == 2


def test_first_linearisation_skips_only_an_exact_power(columns_lib):
    """At z* = delz the header takes p* = p0 without powf: that equals
    p0 (clamp(delz) / clamp(z*))^gamma wherever the ratio is finite, and
    a NaN or infinite delz still reaches the result as it does in plain."""
    w, delz, pt, delp = _columns(8, seed=9)
    delz[0, 0, 0, 3] = np.nan
    delz[0, 1, 1, 5] = np.inf
    got = _host_solve(columns_lib, w, delz, pt, delp)
    want = dsw.nh_vertical_solve_plain(
        *map(torch.from_numpy, (w, delz, pt, delp)), DT, PTOP)
    w_rel, w_atol, z_rel = DEFAULT_GATES
    for g, p, rel, atol in ((got[0], want[0], w_rel, w_atol),
                            (got[1], want[1], z_rel, 0.0)):
        p = p.numpy()
        assert np.array_equal(np.isnan(g), np.isnan(p))
        assert np.isnan(p).any() and not np.isnan(p).all()
        ok = np.isfinite(p)
        assert np.array_equal(np.isfinite(g), ok)
        scale = float(np.abs(p[ok]).max())
        assert float(np.abs(g[ok] - p[ok]).max()) <= max(rel * scale, atol)

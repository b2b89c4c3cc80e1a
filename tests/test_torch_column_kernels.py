"""The plain version of each of the seven column-physics kernels against
the JAX package's Pallas kernel in interpret mode, on the CPU.

The port's wrappers (ops/kernels/{columns,microphysics,standalone_twins}.py)
run their plain versions on CPU tensors; the CUDA kernels repeat those
operation by operation and are held to them on a card
(tests/test_torch_cuda.py, chip_smoke.py).  The reference for each:
fill_q2_zero_pallas, buoyancy_pallas, evap_subl_pdf_pallas,
gfdl_microphysics_pallas, and for aer_activation, moist_rad_coup and
cup_gf_sh `column_kernel_call` with the gate's body, all as the physics
task runs them off the TPU (interpret=True).

Inputs: the gate's synthetic soundings, two at the gate's 128 x 40 and one
at a ragged 123 x 16 (a column count no block size divides); for cup_gf_sh
and aer_activation also K 1, 2, 3 and 32 at 1, 3, 255 and 257 columns, so
that the flat [ncol * K] index of their CUDA kernels mostly ends inside a
block's run of points and the columns cross the reference's 256-column
panes (K = 1 is the top level of a two-level sounding: the gate's recipe
needs two levels).  Gates per
variable: relative RMS <= 1e-4 (the reference's dual-build gate) and, per
point relative to max|reference|, 2e-6; GFDLMicrophysics qr, qi, precip
2e-5 (pow and exp an ulp apart, carried down the sedimentation recurrence;
measured 7.0e-6); Buoyancy 2e-4 (num/den - 1 is ~2e-3, so one ulp of the
ratio is 3e-5 of B; measured 5.8e-5).

Then the dual-build gate itself on the CPU, primaries against the wrappers,
for all seven; and that a wrapper on the CPU counts no launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.harness.tasks import physics_standalone as ref  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import columns as kcolumns  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import microphysics as kmicro  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import \
    standalone_twins as ktwins  # noqa: E402
from geosongpu_tpu_torch.physics import standalone_gate as gate  # noqa: E402

NAMES = list(gate.KERNELS)
CASES = [(1000, 128, 40), (1001, 128, 40), (7, 123, 16)]
POINT_TOL = {("Buoyancy", "b"): 2e-4,
             **{("GFDLMicrophysics", v): 2e-5 for v in ("qr", "qi",
                                                        "precip")}}
WRAPPERS = kcolumns.KERNELS + ktwins.KERNELS + (kmicro.gfdl_microphysics,)


EDGE_KS = [1, 2, 3, 32]
EDGE_NCOLS = [1, 3, 255, 257]


def _matches_pallas_interpret(name, data):
    """The plain version of `name` on `data` within the point gates of the
    Pallas kernel in interpret mode; -> (reference, plain) outputs."""
    ncol, K = data["t"].shape
    want = ref._run_kernel_pallas(name, data)
    before = [w.launches for w in WRAPPERS]
    got = gate.run_kernel_fused(name, data, "cpu")
    assert [w.launches for w in WRAPPERS] == before   # CPU: plain, no launch
    assert set(got) == set(want)
    for var, a in want.items():
        b = got[var]
        assert b.dtype == np.float32 and b.shape == a.shape, var
        assert b.shape == ((ncol,) if var == "precip" else (ncol, K)), var
        tol = POINT_TOL.get((name, var), 2e-6)
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), var
    return want, got


@pytest.mark.parametrize("seed,ncol,K", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_plain_version_matches_pallas_interpret(name, seed, ncol, K):
    want, got = _matches_pallas_interpret(
        name, gate.datasets(seed, (ncol, K)))
    gate.check(want, got)


def _top_levels(ncol, K, seed):
    """The gate's sounding at (ncol, K) for any K >= 1: the top K levels
    of one with at least two."""
    d = gate.datasets(seed, (ncol, max(K, 2)))
    return {k: np.ascontiguousarray(v[:, :K]) for k, v in d.items()}


@pytest.mark.parametrize("ncol", EDGE_NCOLS)
@pytest.mark.parametrize("K", EDGE_KS)
@pytest.mark.parametrize("name", ["CupGfSh", "AerActivation"])
def test_plain_version_matches_pallas_interpret_at_edges(name, K, ncol):
    data = _top_levels(ncol, K, 3000 + 7 * K + ncol)
    want, got = _matches_pallas_interpret(name, data)
    if name == "CupGfSh" and K == 32:
        # not a trivial case: some interface of the sounding mixes
        assert (got["t"] != data["t"]).any()
        assert (want["t"] != data["t"]).any()


def test_wrappers_are_the_seven_kernels():
    assert list(gate.WRAPPERS) == NAMES
    assert set(gate.WRAPPERS.values()) == set(WRAPPERS)


@pytest.mark.parametrize("name", NAMES)
def test_dual_build_gate_on_cpu(name):
    worst = gate.run_gate(name, "cpu")
    assert 0.0 <= worst <= gate.REL_TOL
    if name in ("Buoyancy", "EvapSublPdfLoop"):
        assert worst > 0.0      # two sources, not one function called twice


def test_gate_reports_a_miss():
    data = gate.datasets(1000)
    good = gate.run_kernel("Buoyancy", data, "cpu")
    bad = {"b": good["b"] * np.float32(1.001)}
    with pytest.raises(gate.GateMiss, match="var b"):
        gate.check(good, bad)
    with pytest.raises(gate.GateMiss):
        gate.check(good, {"c": good["b"]})


def test_wrappers_keep_leading_shape_on_cpu():
    d = {k: torch.from_numpy(v.reshape(2, 3, 4, 10))
         for k, v in gate.datasets(3, (24, 10)).items()}
    out = kmicro.gfdl_microphysics(d["t"], d["qv"], d["ql"], d["qr"],
                                   d["qi"], d["p"], d["delp"], 600.0)
    assert [tuple(o.shape) for o in out] == [(2, 3, 4, 10)] * 5 + [(2, 3, 4)]
    assert tuple(kcolumns.fill_q2_zero(d["q_neg"], d["delp"]).shape) \
        == (2, 3, 4, 10)
    assert tuple(ktwins.buoyancy(d["t"], d["qv"], d["p"], d["t"] + 0.5,
                                 d["qv"]).shape) == (2, 3, 4, 10)


def test_twin_keeps_its_own_sublimation_heat():
    """The twin's L_s (2.834e6) is not thermo.HLS (2.836e6), in the JAX
    package and here alike (ROADMAP section C)."""
    from geosongpu_tpu.ops.pallas import standalone_twins as jtwins
    from geosongpu_tpu_torch.physics import thermo

    assert ktwins._LS == jtwins._LS == 2.834e6 and thermo.HLS == 2.836e6

"""The port's seven standalone physics primaries against the JAX package's
(physics/standalone.py), on the five datasets of the physics gate
(harness/tasks/physics_standalone.py, seeds 1000-1004, 128 x 40), on the
CPU.

Tolerances, per variable and relative to max|reference|:
* 2e-6 by default: the same float32 formulas, two exp/pow/log/erf
  implementations an ulp apart;
* GFDLMicrophysics qr and qi 2e-5: five pow and a dozen exp feed the
  sedimentation recurrence, which carries an error down the column
  (measured 7.9e-6 and 5.4e-6);
* Buoyancy 2e-4: Tv_p - Tv_e is 0.5 K of 300 K, so one ulp of a virtual
  temperature (3e-5 K) is 6e-5 of B (measured 6.9e-5).
Every variable also passes the gate's own measure, relative RMS <= 1e-4.

Then the port's copy of the gate's datasets bit for bit, and the port's
own physical properties: column water conserved up to precipitation, and
fill_q2_zero's non-negativity and mass conservation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.harness.tasks import physics_standalone as ref  # noqa: E402
from geosongpu_tpu_torch.physics import standalone as K  # noqa: E402
from geosongpu_tpu_torch.physics import standalone_gate as gate  # noqa: E402

SEEDS = [1000 + i for i in range(gate.N_DATASETS)]
POINT_TOL = {("GFDLMicrophysics", "qr"): 2e-5,
             ("GFDLMicrophysics", "qi"): 2e-5, ("Buoyancy", "b"): 2e-4}


def test_gate_constants_and_kernel_names_match():
    assert (gate.N_DATASETS, gate.REL_TOL, gate.SHAPE) == \
        (ref.N_DATASETS, ref.REL_TOL, ref.SHAPE)
    assert list(gate.KERNELS) == list(ref.KERNELS)
    assert set(gate.FUSED) == set(gate.KERNELS)


@pytest.mark.parametrize("seed", SEEDS)
def test_datasets_copy_is_bit_for_bit(seed):
    a, b = ref._datasets(seed), gate.datasets(seed)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32 and \
            a[k].shape == gate.SHAPE
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(ref.KERNELS))
def test_primary_matches_jax(name, seed):
    data = ref._datasets(seed)
    want = ref._run_kernel(name, data)
    got = gate.run_kernel(name, data, "cpu")
    assert set(got) == set(want)
    for var, a in want.items():
        b = got[var]
        assert b.dtype == np.float32 and b.shape == a.shape, var
        tol = POINT_TOL.get((name, var), 2e-6)
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), var
    gate.check(want, got)


def _tensors(seed):
    return {k: torch.from_numpy(v) for k, v in gate.datasets(seed).items()}


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_microphysics_conserves_column_water_up_to_precip(seed):
    d = _tensors(seed)
    out = K.gfdl_microphysics(d["t"], d["qv"], d["ql"], d["qr"], d["qi"],
                              d["p"], d["delp"], 600.0)
    w = d["delp"].double() / 9.80665
    before = ((d["qv"] + d["ql"] + d["qr"] + d["qi"]).double() * w).sum(-1)
    after = ((out.qv + out.ql + out.qr + out.qi).double() * w).sum(-1) \
        + out.precip.double()
    assert float((after - before).abs().max()) <= 1e-5 * float(before.max())
    assert float(out.precip.min()) >= 0.0 and float(out.precip.max()) > 0.0
    for f in (out.qv, out.ql, out.qr, out.qi):
        assert float(f.min()) >= -1e-9


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_fill_q2_zero_is_non_negative_and_conserves_mass(seed):
    d = _tensors(seed)
    q, delp = d["q_neg"], d["delp"]
    assert float(q.min()) < 0.0
    out = K.fill_q2_zero(q, delp)
    assert float(out.min()) >= 0.0
    # the column mass changes only by what the bottom layer's clip adds:
    # the deficit that reaches the bottom (a float64 recurrence here)
    qd, dp = q.double().numpy(), delp.double().numpy()
    deficit = np.zeros(qd.shape[0])
    for k in range(qd.shape[1]):
        deficit = np.minimum(qd[:, k] * dp[:, k] + deficit, 0.0)
    gained = (out.double().numpy() * dp).sum(-1) - (qd * dp).sum(-1)
    scale = (np.abs(qd) * dp).sum(-1).max()
    assert (deficit < 0.0).any() and (deficit == 0.0).any()
    assert np.abs(gained + deficit).max() <= 1e-6 * scale

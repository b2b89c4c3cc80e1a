"""The port's moist thermodynamics against the JAX package's
(physics/thermo.py): every function on one seeded sounding, 1e-6 relative
to the largest value (both are float32; the two exp implementations differ
by an ulp)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.physics import thermo as jt  # noqa: E402
from geosongpu_tpu_torch.physics import thermo as tt  # noqa: E402

RTOL = 1e-6


def _sounding(seed=0, shape=(50, 24)):
    rng = np.random.default_rng(seed)
    p = np.linspace(500.0, 1.02e5, shape[1])[None] * np.ones((shape[0], 1))
    t = 200.0 + 100.0 * (p / 1.0e5) ** 0.28 + rng.normal(0, 3, shape)
    qv = np.abs(rng.normal(5e-3, 5e-3, shape))
    qc = np.abs(rng.normal(2e-4, 2e-4, shape))
    return tuple(a.astype(np.float32) for a in (t, p, qv, qc))


def test_constants_match():
    for name in ("RDGAS", "RVGAS", "EPS", "CP_AIR", "GRAV", "HLV", "HLS",
                 "T_ICE"):
        assert getattr(tt, name) == getattr(jt, name), name


@pytest.mark.parametrize("fn,args", [
    ("esat_liquid", "t"), ("esat_ice", "t"), ("qsat", "tp"),
    ("qsat_ice", "tp"), ("dqsat_dt", "tp"), ("t_virtual", "tv"),
    ("t_virtual", "tvc")])
def test_function_matches_jax(fn, args):
    t, p, qv, qc = _sounding()
    pick = {"t": t, "p": p, "v": qv, "c": qc}
    a = [pick[c] for c in args]
    ref = np.asarray(getattr(jt, fn)(*(jnp.asarray(x) for x in a)))
    got = getattr(tt, fn)(*(torch.from_numpy(x) for x in a))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.isfinite(ref).all()
    assert np.abs(got.numpy() - ref).max() <= RTOL * np.abs(ref).max()

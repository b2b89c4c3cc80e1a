"""Port column and stencil operators against the JAX reference.

Gate: 1e-6 x max|ref|.  The operators are the same f32 arithmetic; the
reference's K-cumsum is a matmul whose summation order differs from
torch.cumsum, and XLA may contract multiply-adds differently."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.ops import fvtp2d as jfv  # noqa: E402
from geosongpu_tpu.ops import ppm as jppm  # noqa: E402
from geosongpu_tpu.ops import vertical as jvert  # noqa: E402
from geosongpu_tpu_torch.ops import fvtp2d as tfv  # noqa: E402
from geosongpu_tpu_torch.ops import ppm as tppm  # noqa: E402
from geosongpu_tpu_torch.ops import vertical as tvert  # noqa: E402

GATE = 1e-6
SHAPE = (6, 10, 9, 5)   # padded [F, J, I, K]


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, gate=GATE):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= gate * scale, (err, scale)


def test_cumsum_k_and_interfaces():
    delp = _rng(0).uniform(50.0, 3000.0, (6, 4, 4, 8)).astype(np.float32)
    _close(tvert.cumsum_k(_t(delp)), jvert.cumsum_k(jnp.asarray(delp)))
    _close(tvert.rcumsum_k(_t(delp)), jvert.rcumsum_k(jnp.asarray(delp)))
    _close(tvert.interfaces_from_delp(_t(delp), 100.0),
           jvert.interfaces_from_delp(jnp.asarray(delp), 100.0))


def _field_and_courant(dim, seed):
    rng = _rng(seed)
    q = (1.0 + 0.3 * rng.standard_normal(SHAPE)).astype(np.float32)
    cshape = list(SHAPE)
    cshape[dim] += 1
    c = rng.uniform(-0.9, 0.9, cshape).astype(np.float32)
    return q, c


@pytest.mark.parametrize("hord", [6, 8])
@pytest.mark.parametrize("dim", [1, 2])
def test_ppm_flux(hord, dim):
    q, c = _field_and_courant(dim, 10 + dim)
    ref = jppm.ppm_flux(jnp.asarray(q), jnp.asarray(c), axis=dim, hord=hord)
    _close(tppm.ppm_flux(_t(q), _t(c), dim, hord), ref)


@pytest.mark.parametrize("dim", [1, 2])
def test_upwind_flux(dim):
    q, c = _field_and_courant(dim, 20 + dim)
    ref = jppm.upwind_flux(jnp.asarray(q), jnp.asarray(c), axis=dim)
    np.testing.assert_array_equal(tppm.upwind_flux(_t(q), _t(c), dim).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("hord", [6, 8])
@pytest.mark.parametrize("mass_fluxes", [False, True])
def test_fvtp2d(hord, mass_fluxes):
    rng = _rng(30 + hord)
    F, J, I, K = SHAPE
    qx = (1.0 + 0.3 * rng.standard_normal(SHAPE)).astype(np.float32)
    qy = qx.copy()
    qy[:, :2, :2] += 0.05     # corner blocks differ between the two orders
    area = rng.uniform(0.9, 1.1, (F, J, I, 1)).astype(np.float32)
    crx = rng.uniform(-0.5, 0.5, (F, J, I + 1, K)).astype(np.float32)
    cry = rng.uniform(-0.5, 0.5, (F, J + 1, I, K)).astype(np.float32)
    xfx = (0.1 * crx).astype(np.float32)
    yfx = (0.1 * cry).astype(np.float32)
    kw_j, kw_t = {}, {}
    if mass_fluxes:
        mfx = (50.0 * xfx).astype(np.float32)
        mfy = (50.0 * yfx).astype(np.float32)
        kw_j = dict(mfx=jnp.asarray(mfx), mfy=jnp.asarray(mfy))
        kw_t = dict(mfx=_t(mfx), mfy=_t(mfy))
    ref = jfv.fvtp2d(*(jnp.asarray(a) for a in (qx, qy, crx, cry, xfx, yfx,
                                                area)), hord=hord, **kw_j)
    got = tfv.fvtp2d(*(_t(a) for a in (qx, qy, crx, cry, xfx, yfx, area)),
                     hord=hord, **kw_t)
    _close(got.fx, ref.fx)
    _close(got.fy, ref.fy)
    _close(tfv.ddx(got.fx), jfv.ddx(ref.fx), gate=1e-5)
    _close(tfv.ddy(got.fy), jfv.ddy(ref.fy), gate=1e-5)

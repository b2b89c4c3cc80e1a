"""Port halo fills and chart-corner corrections against the JAX reference.

Fills are pure data movement and must be bit-exact.  The chart corner
corrections contract weights with einsum, whose summation order differs
between XLA and torch: gate 1e-6 x max|ref|."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.chart_corners import build_chart_tables  # noqa: E402
from geosongpu_tpu.parallel import halo as jhalo  # noqa: E402
from geosongpu_tpu_torch.core.chart_corners import ChartCorners  # noqa: E402
from geosongpu_tpu_torch.parallel import halo as thalo  # noqa: E402

N, H, K = 12, 3, 4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ops():
    return jhalo.build_halo_ops(N, H), thalo.build_halo_ops(N, H, CPU)


@pytest.fixture(scope="module")
def chart():
    tables = build_chart_tables(N, H)
    return tables, ChartCorners.from_tables(tables, CPU)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("direction", ["x", "y"])
@pytest.mark.parametrize("trail", [(K,), (K, 2)], ids=["K", "K_tracers"])
def test_fill_bit_exact(ops, direction, trail):
    jops, tops = ops
    a = _rand((6, N, N) + trail, 1)
    ref = np.asarray(jops.fill(jnp.asarray(a), direction))
    got = tops.fill(_t(a), direction).numpy()
    np.testing.assert_array_equal(got, ref)


def test_fill_dgrid_bit_exact(ops):
    jops, tops = ops
    u = _rand((6, N + 1, N, K), 2)
    v = _rand((6, N, N + 1, K), 3)
    ru, rv = jops.fill_dgrid(jnp.asarray(u), jnp.asarray(v))
    gu, gv = tops.fill_dgrid(_t(u), _t(v))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def test_symmetrize_shared_edges_bit_exact():
    u = _rand((6, N + 1, N, K), 4)
    v = _rand((6, N, N + 1, K), 5)
    ru, rv = jhalo.symmetrize_shared_edges(jnp.asarray(u), jnp.asarray(v))
    gu, gv = thalo.symmetrize_shared_edges(_t(u), _t(v))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    # the inputs differed on the shared edges, so the average did change them
    assert not np.array_equal(gu.numpy(), u)


def _close(got, ref, rtol=1e-6):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("direction", ["x", "y", "derived"])
def test_apply_scalar(ops, chart, direction):
    jops, tops = ops
    tables, tchart = chart
    a = 300.0 + _rand((6, N, N, K), 6)
    padded = np.asarray(jops.fill(jnp.asarray(a), "x"))
    ref = tables.apply_scalar(jnp.asarray(padded), direction)
    got = tchart.apply_scalar(_t(padded), direction)
    _close(got.numpy(), ref)
    # the corners did move (the correction is not a no-op on this field)
    assert not np.array_equal(got.numpy(), padded)


def test_apply_scalar_keeps_uniform_fields_exact(chart):
    _, tchart = chart
    a = torch.full((6, N + 2 * H, N + 2 * H, K), 287.5)
    assert torch.equal(tchart.apply_scalar(a, "x"), a)


def test_apply_agrid(ops, chart):
    jops, tops = ops
    tables, tchart = chart
    u = _rand((6, N + 1, N, K), 7)
    v = _rand((6, N, N + 1, K), 8)
    pu, pv = (np.asarray(x) for x in jops.fill_dgrid(jnp.asarray(u),
                                                     jnp.asarray(v)))
    ua = _rand((6, N + 2 * H, N + 2 * H, K), 9)
    va = _rand((6, N + 2 * H, N + 2 * H, K), 10)
    rua, rva = tables.apply_agrid(*(jnp.asarray(x) for x in (ua, va, pu, pv)))
    gua, gva = tchart.apply_agrid(*(_t(x) for x in (ua, va, pu, pv)))
    _close(gua.numpy(), rua)
    _close(gva.numpy(), rva)

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
    assert torch.equal(tchart.apply_scalar(a.clone(), "x"), a)


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


# the gated slot tables of a sharded step: slot k takes face FACES[k]'s
# weights, its corners where GATES[k] is 1
FACES = (0, 0, 1, 1, 2, 3)
GATES = ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 1), (0, 0, 0, 0),
         (1, 1, 1, 1), (0, 0, 1, 0))


@pytest.mark.parametrize("case", ["x", "y", "derived", "agrid",
                                  "slots x", "slots agrid", "narrow x",
                                  "narrow agrid"])
def test_fixed_order_plain_matches_einsum(chart, case):
    """The kernels' plain versions (ops/kernels/chart.py, taps summed in a
    fixed order) against ChartCorners' einsum form within float32 rounding,
    for every weight table and a gated table, and on blocks so narrow
    (4 cells and the halo) that one corner's patch reaches into another
    corner's square; apply_* on CPU tensors is the einsum form, the CPU
    wrapper the plain version, and each patches the arrays it is given in
    place and returns them."""
    from geosongpu_tpu_torch.ops.kernels import chart as kchart

    _, tchart = chart
    if case.startswith("slots"):
        tchart = tchart.for_slots(FACES, GATES)
    Np = 4 + 2 * H if case.startswith("narrow") else N + 2 * H
    rng = np.random.default_rng(11)
    if case.endswith("agrid"):
        ua, va, pu, pv = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for s in ((6, Np, Np, K), (6, Np, Np, K),
                                   (6, Np + 1, Np, K), (6, Np, Np + 1, K)))
        got = kchart.chart_agrid_plain(ua, va, pu, pv, tchart.st_w,
                                       tchart.st_mask, H)
        routed = [ua.clone(), va.clone()]
        assert all(r is b for r, b in zip(kchart.chart_agrid(
            *routed, pu, pv, tchart.st_w, tchart.st_mask, H), routed))
        assert all(torch.equal(a, b) for a, b in zip(routed, got))
        want = [ua.clone(), va.clone()]
        assert all(r is b for r, b in zip(tchart.apply_agrid(*want, pu, pv),
                                          want))
    else:
        direction = case.split()[-1]
        table = {"x": tchart.sc_dw_x, "y": tchart.sc_dw_y,
                 "derived": tchart.sc_ex}[direction]
        a = torch.from_numpy(300.0 + rng.standard_normal((6, Np, Np, K))
                             .astype(np.float32))
        got = (kchart.chart_scalar_plain(a, table, H),)
        routed = a.clone()
        assert kchart.chart_scalar(routed, table, H) is routed
        assert torch.equal(routed, got[0])
        want = (a.clone(),)
        assert tchart.apply_scalar(want[0], direction) is want[0]
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), rtol=2e-7)


def test_fixed_order_plain_keeps_uniform_fields_exact(chart):
    """Deviation form: the plain version leaves a uniform field bit for bit,
    under every table."""
    from geosongpu_tpu_torch.ops.kernels import chart as kchart

    _, tchart = chart
    a = torch.full((6, N + 2 * H, N + 2 * H, K), 287.5)
    for table in (tchart.sc_dw_x, tchart.sc_dw_y, tchart.sc_ex):
        assert torch.equal(kchart.chart_scalar_plain(a, table, H), a)


def _round_f32(x):
    """The float32 nearest an exact Fraction x, ties to even."""
    from fractions import Fraction

    lo = np.float32(float(x))
    if Fraction(float(lo)) > x:
        lo = np.nextafter(lo, np.float32(-np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    dl, dh = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if dl != dh:
        return lo if dl < dh else hi
    return lo if int(lo.view(np.int32)) % 2 == 0 else hi


def test_plain_fma_rounds_once():
    """The plain versions' fused multiply-add rounds a * b + c once, as the
    card's fmaf: on random operands and where float64's own rounding lands
    on a float32 tie (1 + 2^-23 + 2^-24 - 2^-70 rounds down, not to even)."""
    from fractions import Fraction

    from geosongpu_tpu_torch.ops.kernels.chart import _fma

    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal(64).astype(np.float32) for _ in range(3))
    ties = np.array([[1 + 2**-23, 2**-24 * (1 - 2**-23), 1 + 2**-23],
                     [1 + 2**-23, -2**-24 * (1 - 2**-23), -(1 + 2**-23)]],
                    np.float32)
    a, b, c = (np.concatenate([v, ties[:, i]])
               for i, v in enumerate((a, b, c)))
    got = _fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y))
                       + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    assert got.tobytes() == np.array(want, np.float32).tobytes()
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive[-2:] != got[-2:]).all()   # float64 alone rounds twice

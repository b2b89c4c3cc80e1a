"""The port's column idioms (geosongpu_tpu_torch/ops/column_patterns.py):
the reference's four cases (tests/test_column_patterns.py) on the port,
then seeded numpy inputs through both packages, which must agree exactly
(the idioms select, count and average with the same weights in the same
order)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.ops import column_patterns as jcp  # noqa: E402
from geosongpu_tpu_torch.ops import column_patterns as tcp  # noqa: E402


def test_while_in_column_converges():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    out = tcp.while_in_column(q, 0.05, max_iter=500)
    spread = (out.amax(-1) - out.amin(-1)).numpy()
    assert (spread <= 0.05 + 1e-6).all()
    assert torch.isfinite(out).all()


def test_broadcasts():
    q = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    t = tcp.broadcast_top(q).numpy()
    b = tcp.broadcast_bottom(q).numpy()
    assert (t == t[..., :1]).all() and (t[..., 0] == q.numpy()[..., 0]).all()
    assert (b[..., 0] == q.numpy()[..., -1]).all()


def test_value_at_k():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((5, 7, 12)).astype(np.float32)
    k = rng.integers(0, 12, (5, 7)).astype(np.int32)
    out = tcp.value_at_k(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    expect = np.take_along_axis(q, k[..., None], axis=-1)[..., 0]
    np.testing.assert_allclose(out, expect)


def test_first_k_above():
    q = torch.tensor([[0.0, 0.1, 0.5, 0.2], [0.0, 0.0, 0.0, 0.0]])
    out = tcp.first_k_above(q, 0.3).numpy()
    assert out[0] == 2 and out[1] == 4


@pytest.mark.parametrize("seed,threshold,max_iter", [
    (2, 0.05, 500),     # every column converges
    (3, 0.05, 7),       # stopped by max_iter
    (4, 10.0, 50),      # converged from the start: no iteration
])
def test_while_in_column_matches_reference(seed, threshold, max_iter):
    q = np.random.default_rng(seed).standard_normal((3, 5, 9)).astype(
        np.float32)
    got = tcp.while_in_column(torch.from_numpy(q), threshold, max_iter)
    want = jcp.while_in_column(jnp.asarray(q), threshold, max_iter)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k_rank", ["per_column", "broadcast"])
def test_broadcasts_and_value_at_k_match_reference(k_rank):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 6, 10)).astype(np.float32)
    k = rng.integers(0, 10, (4, 6) if k_rank == "per_column"
                     else (4, 6, 1)).astype(np.int32)
    tq, jq = torch.from_numpy(q), jnp.asarray(q)
    for name in ("broadcast_top", "broadcast_bottom"):
        np.testing.assert_array_equal(getattr(tcp, name)(tq).numpy(),
                                      np.asarray(getattr(jcp, name)(jq)))
    np.testing.assert_array_equal(
        tcp.value_at_k(tq, torch.from_numpy(k)).numpy(),
        np.asarray(jcp.value_at_k(jq, jnp.asarray(k))))


def test_first_k_above_matches_reference():
    rng = np.random.default_rng(6)
    q = rng.uniform(0.0, 1.0, (5, 7, 12)).astype(np.float32)
    q[0, 0] = 0.0                       # a column with no hit
    got = tcp.first_k_above(torch.from_numpy(q), 0.9).numpy()
    want = np.asarray(jcp.first_k_above(jnp.asarray(q), 0.9))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 12

"""Port vertical remap: the plain banded version of the remap_banded kernel
against the JAX reference and against the reference's Pallas kernel run
in interpret mode on the CPU; the full form against the reference; the
property tests of tests/test_remap.py on the port.  The CUDA kernel
itself is held to this plain version on the card (test_torch_cuda.py).

Gates: rtol = atol = 2e-5, as tests/test_remap.py's banded-vs-full gate."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.ops import remap as jremap  # noqa: E402
from geosongpu_tpu.ops.pallas.remap import remap_multi_banded_pallas  # noqa: E402
from geosongpu_tpu_torch.ops import remap as tremap  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.remap import remap_banded  # noqa: E402

RTOL = ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _displaced_column(lead, K, seed, shift=0.4):
    """(pe1, pe2): pe2 is pe1 with interior interfaces moved by < shift
    layers (top and bottom kept), as tests/test_remap.py:92-99."""
    rng = np.random.default_rng(seed)
    dp1 = rng.uniform(0.5, 1.5, lead + (K,)).astype(np.float32)
    pe1 = np.concatenate([np.zeros(lead + (1,), np.float32),
                          np.cumsum(dp1, -1)], -1).astype(np.float32)
    pe2 = pe1.copy()
    pe2[..., 1:-1] += rng.uniform(-shift, shift,
                                  lead + (K - 1,)).astype(np.float32)
    pe2.sort(axis=-1)
    return pe1, pe2


def _fields(lead, K, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(lead + (K,)) + 5.0).astype(np.float32)
            for _ in range(n)]


CASES = [((2, 5, 4), 8, 1), ((2, 5, 4), 8, 2), ((3, 4, 3), 12, 2)]


@pytest.mark.parametrize("lead,K,n", CASES)
def test_banded_matches_jax_and_pallas_interpret(lead, K, n):
    pe1, pe2 = _displaced_column(lead, K, seed=K + n)
    qs = _fields(lead, K, n, seed=100 + n)
    band = 3
    got = tremap.remap_fields_banded([_t(q) for q in qs], _t(pe1), _t(pe2),
                                     band=band)
    ref = jremap.remap_fields_banded([jnp.asarray(q) for q in qs],
                                     jnp.asarray(pe1), jnp.asarray(pe2),
                                     band=band)
    pal = remap_multi_banded_pallas([jnp.asarray(q) for q in qs],
                                    jnp.asarray(pe1), jnp.asarray(pe2),
                                    band=band, interpret=True)
    assert len(got) == n
    for g, r, p in zip(got, ref, pal):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=RTOL,
                                   atol=ATOL)


def test_full_remap_matches_jax():
    rng = np.random.default_rng(7)
    K = 10
    pe1 = np.sort(rng.uniform(100.0, 1.0e5, (30, K + 1)), -1)
    pe2 = np.sort(rng.uniform(100.0, 1.0e5, (30, K + 1)), -1)
    for pe in (pe1, pe2):
        pe[:, 0], pe[:, -1] = 100.0, 1.0e5
    pe1, pe2 = pe1.astype(np.float32), pe2.astype(np.float32)
    q = (2.0 + rng.standard_normal((30, K))).astype(np.float32)
    got = tremap.remap_field(_t(q), _t(pe1), _t(pe2))
    ref = jremap.remap_field(jnp.asarray(q), jnp.asarray(pe1),
                             jnp.asarray(pe2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# -- the properties of tests/test_remap.py, on the port ------------------

def test_identity_remap():
    rng = np.random.default_rng(0)
    K = 32
    pe = np.sort(rng.uniform(100.0, 1.0e5, size=(50, K + 1)), axis=-1)
    pe[:, 0], pe[:, -1] = 100.0, 1.0e5
    q = rng.standard_normal((50, K)).astype(np.float32)
    pe = _t(pe.astype(np.float32))
    out = tremap.remap_field(_t(q), pe, pe)
    np.testing.assert_allclose(out.numpy(), q, rtol=1e-3, atol=1e-3)


def test_conservation():
    rng = np.random.default_rng(1)
    K, ncol = 24, 40
    pes = []
    for _ in range(2):
        pe = np.sort(rng.uniform(100.0, 1.0e5, size=(ncol, K + 1)), axis=-1)
        pe[:, 0], pe[:, -1] = 100.0, 1.0e5
        pes.append(pe)
    q = (2.0 + rng.standard_normal((ncol, K))).astype(np.float32)
    out = tremap.remap_field(_t(q), _t(pes[0].astype(np.float32)),
                             _t(pes[1].astype(np.float32))).numpy()
    m1 = np.sum(q * np.diff(pes[0], axis=-1), axis=-1)
    m2 = np.sum(out * np.diff(pes[1], axis=-1), axis=-1)
    np.testing.assert_allclose(m2, m1, rtol=5e-5)


def test_smooth_profile_accuracy():
    K = 64
    x1 = np.linspace(0, 1, K + 1) ** 1.3
    x2 = np.linspace(0, 1, K + 1) ** 0.8
    pe1 = (100.0 + (1e5 - 100.0) * x1)[None, :]
    pe2 = (100.0 + (1e5 - 100.0) * x2)[None, :]
    pm1 = 0.5 * (pe1[:, 1:] + pe1[:, :-1])
    pm2 = 0.5 * (pe2[:, 1:] + pe2[:, :-1])
    p1, p2 = _t(pe1.astype(np.float32)), _t(pe2.astype(np.float32))
    f = lambda p: np.exp(p / 1e5) + 0.5 * (p / 1e5) ** 2
    out = tremap.remap_field(_t(f(pm1).astype(np.float32)), p1, p2).numpy()
    assert np.abs(out - f(pm2)).max() < 1e-3
    g = lambda p: np.sin(3 * p / 1e5)
    out2 = tremap.remap_field(_t(g(pm1).astype(np.float32)), p1, p2).numpy()
    assert np.abs(out2 - g(pm2)).max() < 3e-2


def test_monotone_no_overshoot():
    K = 32
    pe1 = np.linspace(100.0, 1e5, K + 1)[None, :]
    x = np.linspace(0, 1, K + 1) ** 1.5
    pe2 = (100.0 + (1e5 - 100.0) * x)[None, :]
    q = np.where(np.arange(K) < K // 2, 1.0, 0.0)[None, :].astype(np.float32)
    out = tremap.remap_field(_t(q), _t(pe1.astype(np.float32)),
                             _t(pe2.astype(np.float32))).numpy()
    assert out.min() >= -1e-6 and out.max() <= 1.0 + 1e-6


def test_banded_remap_matches_full():
    K = 24
    pe1, pe2 = _displaced_column((5, 7), K, seed=3)
    q = _fields((5, 7), K, 1, seed=3)[0]
    full = tremap.remap_field(_t(q), _t(pe1), _t(pe2))
    for band in (2, 4, 10):
        b = tremap.remap_field_banded(_t(q), _t(pe1), _t(pe2), band=band)
        np.testing.assert_allclose(b.numpy(), full.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_banded_remap_conserves_mass():
    K = 32
    pe1, pe2 = _displaced_column((4,), K, seed=4, shift=0.3)
    q = _fields((4,), K, 1, seed=4)[0] - 2.0
    out = tremap.remap_field_banded(_t(q), _t(pe1), _t(pe2), band=6).numpy()
    m1 = (q * np.diff(pe1, axis=-1)).sum(-1)
    m2 = (out * np.diff(pe2, axis=-1)).sum(-1)
    np.testing.assert_allclose(m2, m1, rtol=1e-5)


def test_wrapper_rejects_other_kords():
    pe1, pe2 = _displaced_column((2,), 6, seed=5)
    q = _fields((2,), 6, 1, seed=5)[0]
    with pytest.raises(NotImplementedError):
        remap_banded([_t(q)], _t(pe1), _t(pe2), kord=6)


def _smooth_column(lead, K, band, seed):
    """(pe1, pe2): pe2 displaced smoothly by up to 0.9 x band/2 layers
    (interfaces at fractional source index k + a sin(pi k / K)), so that
    target layers stay comparable to source layers, as the card tests of
    tests/test_torch_cuda.py make them."""
    rng = np.random.default_rng(seed)
    dp1 = rng.uniform(0.5, 1.5, lead + (K,))
    pe1 = np.concatenate([np.zeros(lead + (1,)), np.cumsum(dp1, -1)], -1)
    amp = rng.uniform(-1.0, 1.0, lead + (1,)) * 0.45 * min(band, K - 1)
    k = np.arange(K + 1)
    x = k + amp * np.sin(np.pi * k / K)
    idx = np.clip(np.floor(x).astype(int), 0, K - 1)
    pe2 = (np.take_along_axis(pe1, idx, -1)
           + (x - idx) * np.take_along_axis(dp1, idx, -1))
    pe2[..., 0], pe2[..., -1] = pe1[..., 0], pe1[..., -1]
    return pe1.astype(np.float32), pe2.astype(np.float32)


def test_wrapper_takes_more_fields_than_one_launch():
    """Six fields (a nonhydrostatic run's pt, two tracers, w and delz with
    one more) through the wrapper, which groups them into launches of up
    to MAX_FIELDS, against the reference's Pallas kernel in interpret mode
    on the same inputs; gates RTOL, ATOL."""
    from geosongpu_tpu_torch.ops.kernels.remap import MAX_FIELDS

    lead, K, band, n = (2, 4, 3), 10, 3, 6
    assert n > MAX_FIELDS
    pe1, pe2 = _smooth_column(lead, K, band, seed=21)
    qs = _fields(lead, K, n, seed=22)
    got = remap_banded([_t(q) for q in qs], _t(pe1), _t(pe2), band=band)
    pal = remap_multi_banded_pallas([jnp.asarray(q) for q in qs],
                                    jnp.asarray(pe1), jnp.asarray(pe2),
                                    band=band, interpret=True)
    assert len(got) == n
    for g, p in zip(got, pal):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=RTOL,
                                   atol=ATOL)
    with pytest.raises(ValueError):
        remap_banded([], _t(pe1), _t(pe2), band=band)

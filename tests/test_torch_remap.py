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


# -- the premise of the remap_banded kernel's walk ---------------------------
#
# csrc/remap_banded.cu forms each source layer's parabola once and, for each
# target layer l, adds only the contiguous run of source layers whose
# overlap with [pe2[l], pe2[l+1]] is not empty, in increasing d, where the
# plain version adds every slot l-band..l+band.  That changes no bit if each
# slot outside the run adds an exact zero.  These tests hold that premise on
# the CPU: the walk equals remap_fields_banded bit for bit, and the same
# walk in the other order does not.

def _run_walk(qs, pe1, pe2, band, reverse=False):
    """remap_fields_banded as the kernel computes it, one target layer at a
    time over all columns: the parabolas once per source layer (the plain
    version's _ppm_edges_k); for target layer l the first source layer of
    l-band..l+band whose lower interface lies below pe2[l], then the run of
    layers from there whose upper interface lies above pe2[l+1], each
    slot's integral added in that order (in the reverse order with
    `reverse`)."""
    K = qs[0].shape[-1]
    band = min(band, K - 1)
    pe1, pe2 = pe1.reshape(-1, K + 1), pe2.reshape(-1, K + 1)
    qs = [q.reshape(-1, K) for q in qs]
    dp1 = pe1[:, 1:] - pe1[:, :-1]
    rdp1 = 1.0 / dp1
    edges = [tremap._ppm_edges_k(q, dp1) for q in qs]
    cols = torch.arange(pe1.shape[0])
    outs = [torch.empty_like(q) for q in qs]
    for l in range(K):
        lo2, hi2 = pe2[:, l], pe2[:, l + 1]
        k_end = min(K - 1, l + band)
        k = torch.full_like(cols, max(0, l - band))
        for _ in range(2 * band + 1):
            k = k + ((k <= k_end)
                     & (pe1[cols, (k + 1).clamp(max=K)] <= lo2)).long()
        run, live = [], torch.ones_like(lo2, dtype=torch.bool)
        for _ in range(2 * band + 1):
            kk = k.clamp(max=K - 1)
            live = live & (k <= k_end) & (pe1[cols, kk] < hi2)
            run.append((kk, live))
            k = k + 1
        tots = [torch.zeros_like(lo2) for _ in qs]
        for kk, live in (run[::-1] if reverse else run):
            lo_s, hi_s = pe1[cols, kk], pe1[cols, kk + 1]
            dp_s, rdp_s = dp1[cols, kk], rdp1[cols, kk]
            x0 = torch.clamp((torch.maximum(lo_s, lo2) - lo_s) * rdp_s,
                             0.0, 1.0)
            x1 = torch.maximum(torch.clamp(
                (torch.minimum(hi_s, hi2) - lo_s) * rdp_s, 0.0, 1.0), x0)
            for n, (aL, aR, a6) in enumerate(edges):
                c = tremap._partial_integral(aL[cols, kk], aR[cols, kk],
                                             a6[cols, kk], x0, x1) * dp_s
                tots[n] = torch.where(live, tots[n] + c, tots[n])
        for out, t in zip(outs, tots):
            out[:, l] = t * (1.0 / (hi2 - lo2))
    return [o.reshape(pe2.shape[:1] + (K,)) for o in outs]


def _card_columns(lead, K, band, n):
    """The columns of the card tests (tests/test_torch_cuda.py::_column)."""
    from test_torch_cuda import _column

    pe1, pe2, qs = _column(lead, K, band, seed=11)
    return [_t(q) for q in qs[:n]], _t(pe1), _t(pe2)


def _assert_walk_is_plain(qs, pe1, pe2, band):
    want = tremap.remap_fields_banded(qs, pe1, pe2, band=band)
    got = _run_walk(qs, pe1, pe2, band)
    for g, w in zip(got, want):
        assert torch.equal(g, w.reshape(g.shape))


@pytest.mark.parametrize("band", [3, 6])
@pytest.mark.parametrize("lead,K", [((2, 3), 2), ((3, 5, 4), 9),
                                    ((6, 7, 5), 16), ((37,), 72)])
def test_kernel_walk_is_the_plain_remap(lead, K, band):
    _assert_walk_is_plain(*_card_columns(lead, K, band, 4), band)


def test_kernel_walk_is_the_plain_remap_on_a_model_state():
    """The three remap calls of a c12-L8 Held-Suarez step (pt with the
    tracer, then u and v on their staggered columns), from a state with 3 K
    of pt noise after one step."""
    from geosongpu_tpu_torch.core.config import DycoreConfig
    from geosongpu_tpu_torch.dycore import fv_dynamics
    from geosongpu_tpu_torch.models.held_suarez import build_model

    cfg = DycoreConfig(npx=12, npz=8, dt=1200.0, n_split=2, hord_tm=6)
    model = build_model(cfg, "cpu")
    state = model.run(model.init(perturb=3.0), 1)
    calls = []

    def record(qs, pe1, pe2, kord, band):
        calls.append((qs, pe1, pe2, band))
        return remap_banded(qs, pe1, pe2, kord, band)

    real = fv_dynamics.remap_banded
    fv_dynamics.remap_banded = record
    try:
        model.step(state)
    finally:
        fv_dynamics.remap_banded = real
    assert [len(c[0]) for c in calls] == [2, 1, 1]
    for qs, pe1, pe2, band in calls:
        assert band == cfg.remap_band
        _assert_walk_is_plain(qs, pe1, pe2, band)


def test_the_walk_premise_fails_where_it_should():
    """The same walk, each run taken from its last layer up: the order of
    the terms shows, so the equality above is able to fail."""
    qs, pe1, pe2 = _card_columns((37,), 72, 6, 2)
    want = tremap.remap_fields_banded(qs, pe1, pe2, band=6)
    got = _run_walk(qs, pe1, pe2, 6, reverse=True)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("ntracers", [0, 2])
def test_lagrangian_to_eulerian_matches_jax(ntracers):
    """The full remap step onto the hybrid coordinate of the column's own
    surface pressure, the port against the JAX function, tracers
    included (None without)."""
    from geosongpu_tpu_torch.core.vertical import hybrid_coordinate

    lead, K, ptop = (2, 4, 3), 10, 100.0
    ak, bk = (a.astype(np.float32) for a in hybrid_coordinate(K, ptop))
    rng = np.random.default_rng(7 + ntracers)
    ps = rng.uniform(9.6e4, 1.02e5, lead).astype(np.float32)
    target = np.diff(ak + bk * ps[..., None], axis=-1)
    # a smooth Lagrangian deformation of the target layers
    k = np.arange(K)
    wave = 1.0 + 0.2 * np.sin(np.pi * (k + 0.5) / K
                              + rng.uniform(0, np.pi, lead + (1,)))
    delp = (target * wave / (wave * target).sum(-1, keepdims=True)
            * target.sum(-1, keepdims=True)).astype(np.float32)
    pt, u, v = (rng.uniform(250.0, 320.0, lead + (K,)).astype(np.float32)
                if i == 0 else
                rng.standard_normal(lead + (K,)).astype(np.float32) * 10.0
                for i in range(3))
    q = (rng.uniform(0.0, 1e-2, lead + (K, ntracers)).astype(np.float32)
         if ntracers else None)
    got = tremap.lagrangian_to_eulerian(
        _t(delp), _t(pt), _t(u), _t(v), None if q is None else _t(q),
        _t(ak), _t(bk), ptop)
    want = jremap.lagrangian_to_eulerian(
        jnp.asarray(delp), jnp.asarray(pt), jnp.asarray(u), jnp.asarray(v),
        None if q is None else jnp.asarray(q), jnp.asarray(ak),
        jnp.asarray(bk), ptop)
    names = ("delp", "pt", "u", "v", "q", "ps", "pe2")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)

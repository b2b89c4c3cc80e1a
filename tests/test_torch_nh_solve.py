"""The nonhydrostatic vertical solve as one kernel (ops/kernels/dsw.py::
nh_vertical_solve) on the CPU, where its wrapper runs the plain version.

* `nh_vertical_solve_plain` against the JAX package's composition of the
  same glue, written here as sw_pallas.py:622-629 writes it (interface w,
  `nh_solver.vertical_acoustic_solve`, delz clamped at 1 m, layer w), on
  seeded columns made as tests/test_torch_nh.py::_columns makes them: a few
  columns at K = 8, an odd K = 7, K = 2 (one unknown), a column with two
  layers thinner than 1 m so that the clamps bite, and balanced columns at
  rest.  The gates are those of test_torch_nh.py's solve: 1e-4 relative, w
  with a floor of 1e-4 m/s.
* The wrapper on CPU tensors is its plain version bit for bit and launches
  nothing; it refuses float64, non-contiguous and misshapen inputs and
  fewer than two levels, on the CPU as on the card.
* Both substep forms, eager and fused, call the wrapper once a
  nonhydrostatic substep.  The substeps themselves stay held against the
  JAX package's (tests/test_torch_sw.py, tests/test_torch_sw_fused.py
  MODES "nh" and "nh+tracers").

The card's test, kernel against plain at 0.0, is in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from geosongpu_tpu.dycore import nh_solver as jnh  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.dycore import sw as tsw  # noqa: E402
from geosongpu_tpu_torch.dycore.sw_fused import \
    d_sw_substep_fused  # noqa: E402
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import dsw  # noqa: E402

PTOP = 100.0
DT = 100.0          # the c48-L72 presets' acoustic substep: 600 s / 6
GATE = 1e-4
W_ATOL = 1e-4       # m/s


def _within(name, ref, got, rtol=GATE, atol=0.0):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    assert np.isfinite(got).all(), name
    scale = float(np.abs(ref).max())
    d = float(np.abs(ref - got).max())
    assert d <= max(rtol * scale, atol), (name, d, scale)


def _columns(K, lead=(1, 3, 5), seed=1):
    """Seeded glue inputs [*lead, K]: delp varying by 10% about an even
    split of 1e5 Pa, pt isothermal-like with 2 K of noise, delz in
    hydrostatic balance (the JAX package's hydrostatic_delz) squeezed and
    stretched by 5%, layer w of 0.1 m/s.  Returns float32
    (w_adv, delz_adv, pt_new, delp_new)."""
    rng = np.random.default_rng(seed)
    pe = np.linspace(PTOP, 1.0e5, K + 1)
    delp = (np.diff(pe) * (1.0 + 0.1 * rng.uniform(-1, 1, lead + (K,)))
            ).astype(np.float32)
    pk_mid = (0.5 * (pe[1:] + pe[:-1]) / 1e5) ** 0.2857
    pt = (280.0 / pk_mid + 2.0 * rng.standard_normal(lead + (K,))
          ).astype(np.float32)
    w = (0.1 * rng.standard_normal(lead + (K,))).astype(np.float32)
    squeeze = 1.0 + 0.05 * np.sin(np.arange(K) / 3.0)
    delz = (np.asarray(jnh.hydrostatic_delz(jnp.asarray(delp),
                                            jnp.asarray(pt), PTOP))
            * squeeze).astype(np.float32)
    return w, delz, pt, delp


def _case(name):
    if name == "K8":
        return _columns(8)
    if name == "odd K7":
        return _columns(7, seed=2)
    if name == "K2":
        return _columns(2, seed=3)
    if name == "clamp":
        # one column's two lowest layers thinned to 1 and 2 Pa: in balance
        # they are 0.10 and 0.20 m thick, under the 1 m floor, so that the
        # clamps bite in the anchor, in the linearisation and in the result
        w, _, pt, delp = _columns(8, seed=4)
        delp[0, 1, 2, 6:] = (1.0, 2.0)
        delz = np.asarray(jnh.hydrostatic_delz(
            jnp.asarray(delp), jnp.asarray(pt), PTOP)).astype(np.float32)
        assert float(delz.min()) < 1.0
        return w, delz, pt, delp
    if name == "balanced":
        w, _, pt, delp = _columns(8, seed=5)
        delz = np.asarray(jnh.hydrostatic_delz(
            jnp.asarray(delp), jnp.asarray(pt), PTOP)).astype(np.float32)
        return np.zeros_like(w), delz, pt, delp
    raise KeyError(name)


CASES = ["K8", "odd K7", "K2", "clamp", "balanced"]


def _jax_glue(w_adv, delz_adv, pt_new, delp_new, dt):
    """sw_pallas.py:622-629: the reference's vertical glue."""
    zeros_if = jnp.zeros_like(w_adv[..., :1])
    w_if = jnp.concatenate(
        [zeros_if, 0.5 * (w_adv[..., :-1] + w_adv[..., 1:]), zeros_if],
        axis=-1)
    w_if, delz_new = jnh.vertical_acoustic_solve(w_if, delz_adv, pt_new,
                                                 delp_new, dt, PTOP)
    delz_new = jnp.maximum(delz_new, 1.0)
    return 0.5 * (w_if[..., :-1] + w_if[..., 1:]), delz_new


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_reference_glue(case):
    arrays = _case(case)
    ref_w, ref_z = _jax_glue(*map(jnp.asarray, arrays), DT)
    got_w, got_z = dsw.nh_vertical_solve_plain(
        *map(torch.from_numpy, arrays), DT, PTOP)
    _within("w", ref_w, got_w, atol=W_ATOL)
    _within("delz", ref_z, got_z)
    w, delz = arrays[0], arrays[1]
    if case == "balanced":
        # discrete balance at rest stays there to rounding
        assert float(got_w.abs().max()) < 1e-3
        assert float((got_z - torch.from_numpy(delz)).abs().max()) \
            < 1e-4 * float(delz.max())
    else:
        assert float((got_z - torch.from_numpy(delz)).abs().max()) > 0.0
    if case == "clamp":
        # the thin layers leave the solve at the 1 m floor
        assert float(got_z.min()) == 1.0
        assert int((got_z == 1.0).sum()) == 2


@pytest.mark.parametrize("case", CASES)
def test_wrapper_on_cpu_is_the_plain_version(case):
    args = tuple(map(torch.from_numpy, _case(case))) + (DT, PTOP)
    before = dsw.nh_vertical_solve.launches
    got = dsw.nh_vertical_solve(*args)
    want = dsw.nh_vertical_solve_plain(*args)
    assert dsw.nh_vertical_solve.launches == before == 0
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == args[0].shape
        assert torch.equal(g, w)


def _bad(kind, t):
    if kind == "float64":
        return t.double()
    if kind == "non-contiguous":
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    return t[..., :-1].contiguous()      # misshapen


@pytest.mark.parametrize("arg", range(4))
@pytest.mark.parametrize("kind", ["float64", "non-contiguous", "misshapen"])
def test_wrapper_refuses_bad_inputs(kind, arg):
    args = list(map(torch.from_numpy, _columns(8, lead=(1, 3, 5))))
    args[arg] = _bad(kind, args[arg])
    with pytest.raises(TypeError if kind == "float64" else ValueError):
        dsw.nh_vertical_solve(*args, DT, PTOP)


def test_wrapper_refuses_one_level_and_three_axes():
    args = list(map(torch.from_numpy, _columns(8, lead=(1, 3, 5))))
    with pytest.raises(ValueError):
        dsw.nh_vertical_solve(*[a[..., :1].contiguous() for a in args], DT,
                              PTOP)
    with pytest.raises(ValueError):
        dsw.nh_vertical_solve(*[a[0] for a in args], DT, PTOP)


def test_both_substep_forms_call_the_wrapper(monkeypatch):
    """The eager and the fused nonhydrostatic substep each hand the glue
    to nh_vertical_solve once, on the padded transport outputs, and agree
    on the CPU bit for bit."""
    cfg = DycoreConfig(npx=8, npz=6, dt=1200.0, n_split=2, hord_tm=6,
                       ntracers=1, hydrostatic=False, z_tracer=False)
    model = build_model(cfg, "cpu")
    ctx = model.ctx
    st = model.init(perturb=3.0)
    s = tsw.fill_substep(ctx.ops, st.u, st.v, st.delp, st.pt, w=st.w,
                         delz=st.delz, chart=ctx.chart)
    calls = []
    orig = dsw.nh_vertical_solve

    def recorder(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(dsw, "nh_vertical_solve", recorder)
    kw = dict(hord=cfg.hord, d2_bg=cfg.d2_bg, advect_tracers=False,
              hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm, chart=ctx.chart,
              stag_tabs=ctx.stag)
    dt = cfg.dt / cfg.n_split
    eager = tsw.d_sw_substep(s, ctx.metrics, ctx.ops, dt, cfg.ptop, **kw)
    fused = d_sw_substep_fused(s, ctx.metrics, ctx.ops, dt, cfg.ptop, **kw)
    assert len(calls) == 2
    for a in calls:
        assert a[0].shape == s.pd_x.shape and a[4:] == (dt, cfg.ptop)
    for f in ("w", "delz", "u", "v"):
        assert torch.equal(getattr(eager, f), getattr(fused, f)), f
    assert float(eager.w.abs().max()) > 0.0

"""The port's subtile exchange and sharded step against the JAX package.

* The plan tables (scalar, staggered and twin) of parallel/subtile.py equal
  the JAX package's bit for bit on the faces-local (2, 4) layout at n16 h3
  and the face-sharded (6, 2, 2) and (6, 1, 1) layouts at n8.
* Every fill of SubtileFiller on stacked ranks equals, block by block, the
  single-device fills of the port's HaloOps and of the JAX package's, and
  its shared-edge symmetrization equals symmetrize_shared_edges.
* The stacked sharded step against the port's single-device step, under
  the reference's gate (tests/test_subtile.py: 1e-5 of max|ref| with wind
  floors) on its near-rest start: eager over 2 steps, fused through the
  plain versions over 1, nonhydrostatic, aquaplanet, and overlap_fills +
  rim_split.  On that start the floors hold the winds to 5e-6 m/s, 0.5%
  of their 1e-3 m/s; the same steps run again, one step each, from a
  developed flow, where the floors are inert and the gate is 1e-5 of the
  35 m/s jets.
* From the developed flow: the stacked step against the JAX package's
  build_subtile_step on the conftest's 8 virtual CPU devices (the jnp path
  at c16-L6, one step), and overlap_fills + rim_split on one device
  against the JAX package's step with them.

The developed flow is the JW06 jets (35 m/s) and their balanced
temperature on the Held-Suarez grid and levels (flow_state), where a
wrong exchange, chart gate, block latitude or overlap pad moves the winds
by orders of magnitude more than the gates allow.  Blocks are at least 4
cells wide, so the chart corrections shard too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig
from geosongpu_tpu.core.state import DycoreState as JaxState
from geosongpu_tpu.models.held_suarez import build_model as jax_model
from geosongpu_tpu.parallel import halo as j_halo
from geosongpu_tpu.parallel import subtile as j_sub
from geosongpu_tpu.physics.held_suarez import held_suarez_forcing
from geosongpu_tpu_torch.core.config import DycoreConfig, MeshConfig
from geosongpu_tpu_torch.core.state import state_from_numpy
from geosongpu_tpu_torch.models.aquaplanet import build_model as aq_model
from geosongpu_tpu_torch.models.baroclinic_wave import jw_initial_state
from geosongpu_tpu_torch.models.held_suarez import build_model
from geosongpu_tpu_torch.parallel import subtile as t_sub
from geosongpu_tpu_torch.parallel.comm import StackedGroup
from geosongpu_tpu_torch.parallel.halo import (build_halo_ops,
                                               symmetrize_shared_edges)

CPU = torch.device("cpu")
LAYOUTS = {"faces_local_2x4_n16": (16, 3, 2, 4, False),
           "face_sharded_6x2x2_n8": (8, 3, 2, 2, True),
           "face_sharded_6x1x1_n8": (8, 3, 1, 1, True)}
N, H = 16, 3
LAY = t_sub.SubtileLayout(n=N, h=H, py=2, px=4, face_sharded=False)
# the reference's gate (tests/test_subtile.py:135-159)
WIND_FLOORS = {"u": 0.5, "v": 0.5, "omga": 0.05}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flow_state(model):
    """The JW06 analytic state on the model's grid and levels, over the
    model's flat terrain."""
    s, _ = jw_initial_state(model.config, model.grid, model.ak, model.bk,
                            model.device)
    return dataclasses.replace(s, phis=torch.zeros_like(s.phis))


def _jax_state(state):
    return JaxState(**{k: jnp.asarray(v) for k, v in _np(state).items()})


def _np(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def gate(out, ref, names, floors=WIND_FLOORS):
    for name in names:
        a = np.asarray(getattr(out, name))
        b = np.asarray(getattr(ref, name))
        scale = max(float(np.abs(b).max()), floors.get(name, 0.0), 1e-30)
        assert np.abs(a - b).max() / scale < 1e-5, name


# ---- the plan ------------------------------------------------------------

def _rounds_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.perm == rb.perm and ra.msg_len == rb.msg_len
        assert ra.pack_idx.dtype == rb.pack_idx.dtype
        assert np.array_equal(ra.pack_idx, rb.pack_idx)


@pytest.mark.parametrize("family", ["scalar", "stag", "twins"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plan_equals_reference(name, family):
    got = getattr(t_sub.build_subtile_plan(*LAYOUTS[name]), family)
    want = getattr(j_sub.build_subtile_plan(*LAYOUTS[name]), family)
    assert got.local_len == want.local_len
    _rounds_equal(got.rounds, want.rounds)
    if family == "twins":
        for k in ("tgt", "pos", "sgn"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        return
    assert got.unpack.keys() == want.unpack.keys()
    for k, (idx, sgn, shp) in got.unpack.items():
        widx, wsgn, wshp = want.unpack[k]
        assert shp == wshp and idx.dtype == widx.dtype
        assert np.array_equal(idx, widx), k
        assert (sgn is None) == (wsgn is None), k
        if sgn is not None:
            assert sgn.dtype == wsgn.dtype and np.array_equal(sgn, wsgn), k


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_stack_unstack_round_trip_and_reference(name):
    n, h, py, px, fs = LAYOUTS[name]
    lay = t_sub.SubtileLayout(n=n, h=h, py=py, px=px, face_sharded=fs)
    jlay = j_sub.SubtileLayout(n=n, h=h, py=py, px=px, face_sharded=fs)
    rng = np.random.RandomState(2)
    for sy, sx in ((n, n), (n + 1, n), (n, n + 1), (n + 2 * h, n + 2 * h)):
        a = rng.randn(6, sy, sx, 2).astype(np.float32)
        st = t_sub.stack_blocks(lay, a)
        assert np.array_equal(st, j_sub.stack_blocks(jlay, a))
        assert np.array_equal(t_sub.unstack_blocks(lay, st, sy, sx), a)


@pytest.mark.parametrize("mesh", [dict(face=1, x=4, y=2),
                                  dict(face=6, x=1, y=1),
                                  dict(face=6, x=2, y=2)])
def test_layout_from_mesh(mesh):
    from geosongpu_tpu.core.config import MeshConfig as JaxMesh

    got = t_sub.layout_from_mesh(MeshConfig(**mesh), 16, 3)
    want = j_sub.layout_from_mesh(JaxMesh(**mesh), 16, 3)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


# ---- the fills -----------------------------------------------------------

def _blocks(lay, padded, ry, rx):
    """The held blocks [D*S, ...] of a global padded array (ry/rx: its
    staggering), as the sharded fills lay them out."""
    padded = np.asarray(padded)
    h, out = lay.h, []
    for d in range(lay.ndevices):
        fd, by, bx = lay.dev_coords(d)
        blk = padded[:, by * lay.bny:by * lay.bny + lay.bny + ry + 2 * h,
                     bx * lay.bnx:bx * lay.bnx + lay.bnx + rx + 2 * h]
        out.append(blk[fd:fd + 1] if lay.face_sharded else blk)
    return np.concatenate(out)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fills_match_single_device(name):
    n, h, py, px, fs = LAYOUTS[name]
    lay = t_sub.SubtileLayout(n=n, h=h, py=py, px=px, face_sharded=fs)
    group = StackedGroup(lay.ndevices, CPU)
    filler = t_sub.SubtileFiller(t_sub.build_subtile_plan(n, h, py, px, fs),
                                 group)
    ops = build_halo_ops(n, h, CPU)
    jops = j_halo.build_halo_ops(n, h)
    rng = np.random.RandomState(0)
    f = rng.randn(6, n, n, 3).astype(np.float32)
    u = rng.randn(6, n + 1, n, 2).astype(np.float32)
    v = rng.randn(6, n, n + 1, 2).astype(np.float32)
    place = lambda a: t_sub.place_array(lay, group, a)
    T = torch.from_numpy
    for d in ("x", "y"):
        got = filler.fill(place(f), d).numpy()
        assert np.array_equal(got, _blocks(lay, ops.fill(T(f), d), 0, 0))
        assert np.array_equal(got, _blocks(lay, jops.fill(jnp.asarray(f), d),
                                           0, 0))
    cases = (("dgrid", filler.fill_dgrid(place(u), place(v)),
              ops.fill_dgrid(T(u), T(v)),
              jops.fill_dgrid(jnp.asarray(u), jnp.asarray(v)), (1, 0), (0, 1)),
             ("cgrid", filler.fill_cgrid(place(v), place(u)),
              ops.fill_cgrid(T(v), T(u)),
              jops.fill_cgrid(jnp.asarray(v), jnp.asarray(u)), (0, 1), (1, 0)))
    for kind, got, ref, jref, s0, s1 in cases:
        for g, r, jr, (ry, rx) in zip(got, ref, jref, (s0, s1)):
            assert np.array_equal(g.numpy(), _blocks(lay, r, ry, rx)), kind
            assert np.array_equal(g.numpy(), _blocks(lay, jr, ry, rx)), kind
    su, sv = filler.symmetrize_dgrid(place(u), place(v))
    ru, rv = symmetrize_shared_edges(T(u), T(v))
    assert torch.equal(t_sub.unplace_array(lay, group, su), ru)
    assert torch.equal(t_sub.unplace_array(lay, group, sv), rv)


@pytest.mark.parametrize("direction", ["x", "y"])
def test_single_device_vector_and_cgrid_fills_equal_reference(direction):
    n, h = 8, 3
    ops = build_halo_ops(n, h, CPU)
    jops = j_halo.build_halo_ops(n, h)
    rng = np.random.RandomState(3)
    vy, vx = (rng.randn(6, n, n, 2).astype(np.float32) for _ in range(2))
    got = ops.fill_vector(torch.from_numpy(vy), torch.from_numpy(vx),
                          direction)
    want = jops.fill_vector(jnp.asarray(vy), jnp.asarray(vx), direction)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    uc = rng.randn(6, n, n + 1, 2).astype(np.float32)
    vc = rng.randn(6, n + 1, n, 2).astype(np.float32)
    got = ops.fill_cgrid(torch.from_numpy(uc), torch.from_numpy(vc))
    want = jops.fill_cgrid(jnp.asarray(uc), jnp.asarray(vc))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    pad = ops.fill(torch.from_numpy(vy), direction)
    assert torch.equal(ops.interior(pad), torch.from_numpy(vy))


def test_stacked_group_permute_is_a_partial_permutation():
    g = StackedGroup(4, CPU)
    x = torch.arange(8.0).reshape(4, 2)
    got = g.permute(x, [(0, 2), (3, 0)])
    assert torch.equal(got, torch.tensor([[6.0, 7.0], [0.0, 0.0],
                                          [0.0, 1.0], [0.0, 0.0]]))
    assert torch.equal(g.sum(x), x.sum(0, keepdim=True).expand(4, 2))


# ---- the sharded step ----------------------------------------------------

def _stacked(model, lay=LAY, **kw):
    return t_sub.build_subtile_step(model.ctx, lay, lats=model.lats,
                                    forcing=model.forcing, **kw)


@pytest.mark.parametrize("form,steps", [("eager", 2), ("fused", 1)])
def test_stacked_step_matches_single_device(form, steps):
    cfg = DycoreConfig(npx=N, npz=6, dt=600.0, n_split=2, halo=H,
                       pallas_dycore=form == "fused")
    model = build_model(cfg, CPU)
    state = model.init(perturb=1e-3)
    ref = out = state
    step, place, unplace = _stacked(model)
    out = place(out)
    for _ in range(steps):
        ref = model.step(ref)
        out = step(out)
    gate(unplace(out), ref, ("u", "v", "delp", "pt", "ps", "omga"))


def test_nonhydrostatic_stacked_step():
    cfg = DycoreConfig(npx=N, npz=6, dt=600.0, n_split=2, halo=H,
                       hydrostatic=False)
    model = build_model(cfg, CPU)
    state = model.init(perturb=1e-3)
    step, place, unplace = _stacked(model)
    gate(unplace(step(place(state))), model.step(state),
         ("u", "v", "delp", "pt", "w", "delz"))


def test_aquaplanet_stacked_through_the_mesh_stepper():
    cfg = DycoreConfig(npx=N, npz=6, dt=600.0, n_split=2, halo=H,
                       ntracers=3)
    model = aq_model(cfg, CPU)
    state = model.init(perturb=1e-3)
    place, step, unplace, desc = t_sub.build_mesh_stepper(
        model, MeshConfig(face=1, x=4, y=2), stacked=True)
    assert desc == "subtile faces-local (2,4), 8 devices"
    ref = model.step(model.step(state))
    out = unplace(step(step(place(state))))
    # the reference's floors: condensation onset amplifies ulp-level
    # dycore differences on near-rest winds
    gate(out, ref, ("u", "v", "delp", "pt", "q", "ps"),
         floors={"u": 1.0, "v": 1.0})


def test_overlap_fills_rim_split_stacked_matches_unsplit():
    kw = dict(npx=N, npz=6, dt=600.0, n_split=2, halo=H, overlap_fills=True)
    model = build_model(DycoreConfig(**kw), CPU)
    model_rs = build_model(DycoreConfig(rim_split=True, **kw), CPU)
    state = model.init(perturb=1e-3)
    ref = model.step(model.step(state))
    step, place, unplace = _stacked(model_rs)
    gate(unplace(step(step(place(state)))), ref, ("u", "v", "delp", "pt",
                                                   "ps"))


@pytest.mark.parametrize("case", ["eager", "fused", "nonhydrostatic",
                                  "overlap_fills_rim_split"])
def test_stacked_step_on_a_developed_flow(case):
    """One step from the JW06 flow, stacked against single-device, under
    the reference's gate (its floors are inert at 35 m/s).  The steps
    differ there by design, as the JAX package's do: along a face-edge
    halo strip the chart resample of the A-grid winds reads one cell past
    a block's end, clamped there (5.8e-6 of max|u| here, 1.7e-4 at
    c48-L72).  omga and w are small residuals of large terms (max 0.06
    Pa/s, 0.007 m/s) and are left to the near-rest tests above."""
    kw = dict(npx=N, npz=6, dt=600.0, n_split=2, halo=H,
              pallas_dycore=case == "fused",
              hydrostatic=case != "nonhydrostatic",
              overlap_fills=case == "overlap_fills_rim_split",
              rim_split=case == "overlap_fills_rim_split")
    model = build_model(DycoreConfig(**kw), CPU)
    state = flow_state(model)
    step, place, unplace = _stacked(model)
    names = ("u", "v", "delp", "pt", "ps") + (
        ("delz",) if case == "nonhydrostatic" else ())
    gate(unplace(step(place(state))), model.step(state), names)


@pytest.mark.parametrize("kind", ["held_suarez", "aquaplanet"])
def test_forcing_on_block_latitudes_equals_single_device(kind):
    """The latitudes the stacked step hands its blocks' column physics are
    the model's, bit for bit, and the physics on them equals the
    single-device physics within 4 ulp of the field's largest value (it is
    pointwise in the columns; the CPU's vector and scalar pow/log differ
    by an ulp with an element's place in memory).  From the JW06 flow,
    where the Held-Suarez relaxation and the aquaplanet's SST follow the
    latitudes; the step gates above cannot see a latitude mix-up, since
    one step of relaxation moves pt by millikelvin, ~100 such ulp."""
    cfg = DycoreConfig(npx=N, npz=6, dt=600.0, n_split=2, halo=H,
                       ntracers=3)
    model = (aq_model if kind == "aquaplanet" else build_model)(cfg, CPU)
    state = flow_state(model)
    seen = []

    def record(s, lats_l):
        seen.append(lats_l)
        return s

    step, place, unplace = t_sub.build_subtile_step(
        model.ctx, LAY, lats=model.lats, forcing=record)
    step(place(state))
    (lats_l,) = seen
    group = StackedGroup(LAY.ndevices, CPU)
    for got, want in zip(lats_l, model.lats):
        assert torch.equal(t_sub.unplace_array(LAY, group, got), want)
    got = unplace(model.forcing(place(state), lats_l))
    want = model.forcing(state)
    for f in ("u", "v", "delp", "pt", "q"):
        a, b = getattr(got, f).numpy(), getattr(want, f).numpy()
        assert np.abs(a - b).max() <= 4 * np.spacing(np.abs(b).max()), f


def test_stacked_step_matches_reference_sharded_step():
    """One c16-L6 step of the JAX package's build_subtile_step over the 8
    virtual CPU devices against the port's on 8 stacked ranks, from the
    JW06 flow.  The two packages' single-device steps differ on this state
    by 1.4e-5 of max|u| at most (tests/test_torch_model.py holds them at
    1e-4).  The sharded pair may
    differ by no more than the single-device pair plus 1e-5 of max|ref|,
    the reference's own sharded-vs-single gate; and by at most 3e-5
    (winds) and 1e-5 (the rest) of max|ref|."""
    assert len(jax.devices()) >= 8
    kw = dict(npx=N, npz=6, dt=600.0, n_split=2, halo=H)
    model = build_model(DycoreConfig(**kw), CPU)
    state = flow_state(model)
    jm = jax_model(JaxConfig(**kw))
    jstate = _jax_state(state)

    def forcing(s, lats_l):
        u, v, pt = held_suarez_forcing(s.u, s.v, s.pt, s.delp, lats_l,
                                       jm.config.ptop, jm.config.dt)
        return dataclasses.replace(s, u=u, v=v, pt=pt)

    jlay = j_sub.SubtileLayout(n=N, h=H, py=2, px=4, face_sharded=False)
    jstep, jplace, junplace = j_sub.build_subtile_step(
        jm.ctx, jlay, lats=jm.lats, forcing=forcing)
    want = _np(junplace(jstep(jplace(jstate)), N))
    jsingle = _np(jm.step_fn(jstate))

    step, place, unplace = _stacked(model)
    got = _np(unplace(step(place(state))))
    single = _np(model.step(state))
    for f in ("u", "v", "delp", "pt", "ps"):
        scale = np.abs(want[f]).max()
        d_sharded = np.abs(got[f] - want[f]).max()
        d_single = np.abs(single[f] - jsingle[f]).max()
        assert d_sharded <= d_single + 1e-5 * scale, f
        rel = 3e-5 if f in ("u", "v") else 1e-5
        assert d_sharded <= rel * scale, f


def test_overlap_fills_rim_split_single_device_match_reference():
    """check_supported accepts both options, and one c8-L6 step with them
    from the JW06 flow matches the JAX package's step with them within
    1e-5 of max|ref| (measured 4.8e-6 for u).  The gate resolves the
    option: the port's step without overlap_fills misses it (3.8e-5 for
    u): the pipelined pads move the winds, while delp, pt and ps come out
    the same with and without them."""
    kw = dict(npx=8, npz=6, dt=600.0, n_split=2)
    jm = jax_model(JaxConfig(overlap_fills=True, rim_split=True, **kw))
    model = build_model(DycoreConfig(overlap_fills=True, rim_split=True,
                                     **kw), CPU)
    plain = build_model(DycoreConfig(**kw), CPU)
    state = flow_state(model)
    want = _np(jm.step_fn(_jax_state(state)))
    got = _np(model.step(state))
    for f in ("u", "v", "delp", "pt", "ps"):
        assert (np.abs(got[f] - want[f]).max()
                <= 1e-5 * np.abs(want[f]).max()), f
    u = plain.step(state).u.numpy()
    assert np.abs(u - want["u"]).max() > 1e-5 * np.abs(want["u"]).max()

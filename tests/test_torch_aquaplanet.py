"""The port's aquaplanet model against the JAX model, on the CPU.

c8-L12 (dt 1200, n_split 4, the tracers qv, ql, qr), the configuration of
tests/test_aquaplanet.py.  The JAX model's initial state (3 K of pt noise)
gets a seeded moist perturbation from numpy - vapour up to 1.14 of
saturation, cloud liquid up to 3e-4 and rain up to 1e-4 kg/kg - so that
condensation, autoconversion, sedimentation and evaporation all act; it
takes one JAX step, is carried across with state_from_numpy, and both
models take 3 more steps: the eager pair (both flags off) and the fused
pair (pallas_dycore and pallas_microphysics on; the JAX package runs its
Pallas kernels in interpret mode, the port the plain versions of its CUDA
kernels).

Gates after 3 steps (measured values in brackets, eager / fused): delp, pt,
ps and qv within 1e-4 of max|reference| (1.2e-6, 8.8e-6 / 2.2e-6, 4.7e-7,
6.3e-5 / 1.7e-5), u and v within max(1e-4 max|ref|, 6e-3 m/s) (1.3e-3 m/s).
ql and qr within 1e-4 of max|qv| of the state (1.6e-5 and 3.3e-6), not of
their own maxima (2.7e-3 and 4.5e-3 there): the port's float64 cumsum_k
against the reference's triangular matmul moves pkz by ~1e-5 relative, so T
by ~3e-3 K and qsat by ~2e-4 relative, and the saturation adjustment turns
that difference of vapour into condensate, which is 100 times smaller than
the vapour it came from.

Also: sst_qobs, the moist initial state, the physics chain alone for both
settings of pallas_microphysics, the diagnostics of run_with_history, and
the port's own 12-step stability test.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.models import aquaplanet as jaq  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.models import aquaplanet as taq  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import columns as kcolumns  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import dsw  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.microphysics import \
    gfdl_microphysics  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.remap import remap_banded  # noqa: E402

CPU = torch.device("cpu")
KW = dict(npx=8, npz=12, dt=1200.0, n_split=4, ntracers=3)
FUSED = dict(pallas_dycore=True, pallas_microphysics=True)
GATE = 1e-4
WIND_ATOL = 6e-3
WRAPPERS = dsw.KERNELS + kcolumns.KERNELS + (gfdl_microphysics, remap_banded)


def _np(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def moist_start(jm):
    """The JAX model's initial state with the seeded moist perturbation."""
    s = jm.init(perturb=3.0)
    rng = np.random.default_rng(5)
    q = np.array(s.q)
    q[..., 0] *= 1.0 + 0.9 * rng.random(q.shape[:-1])
    q[..., 1] = 3e-4 * rng.random(q.shape[:-1])
    q[..., 2] = 1e-4 * rng.random(q.shape[:-1])
    return dataclasses.replace(s, q=jnp.asarray(q.astype(np.float32)))


def assert_within_gates(ref, got):
    for f in ("u", "v", "delp", "pt", "ps"):
        a, b = ref[f], got[f]
        assert a.shape == b.shape and b.dtype == np.float32, f
        scale = float(np.abs(a).max())
        atol = WIND_ATOL if f in ("u", "v") else 0.0
        d = float(np.abs(a - b).max())
        assert d <= max(GATE * scale, atol), (f, d, scale)
    assert ref["q"].shape == got["q"].shape
    qv_max = float(np.abs(ref["q"][..., 0]).max())
    for n, name in enumerate(("qv", "ql", "qr")):
        d = float(np.abs(ref["q"][..., n] - got["q"][..., n]).max())
        assert d <= GATE * qv_max, (name, d, qv_max)


def test_sst_qobs_matches_jax():
    lat = np.linspace(-np.pi / 2, np.pi / 2, 101).astype(np.float32)
    ref = np.asarray(jaq.sst_qobs(jnp.asarray(lat)))
    got = taq.sst_qobs(torch.from_numpy(lat)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * ref.max()
    assert abs(got[50] - 300.16) < 0.2 and abs(got[0] - 273.16) < 1e-3


def test_moist_init_matches_jax():
    """perturb=0: the two packages draw their noise from different
    generators, everything else is held."""
    ref = _np(jaq.build_model(JaxConfig(**KW)).init(perturb=0.0))
    model = taq.build_model(DycoreConfig(**KW), CPU)
    got = state_to_numpy(model.init(perturb=0.0))
    for f in ("delp", "pt", "q", "ps"):
        assert got[f].shape == ref[f].shape, f
        assert np.abs(got[f] - ref[f]).max() <= 1e-6 * np.abs(ref[f]).max(), f
    qv = got["q"][..., 0]
    assert qv.min() >= 0.0 and 0.01 < qv.max() < 0.03
    assert not got["q"][..., 1:].any()
    noisy = state_to_numpy(model.init(perturb=1e-3, seed=1))
    assert np.abs(noisy["pt"] - got["pt"]).max() > 1e-4


@pytest.mark.parametrize("flags", [{}, FUSED], ids=["eager", "fused"])
def test_three_steps_match_jax(flags):
    kw = dict(KW, **flags)
    jm = jaq.build_model(JaxConfig(**kw))
    s = jm.step_fn(moist_start(jm))
    start = _np(s)
    for _ in range(3):
        s = jm.step_fn(s)
    ref = _np(s)
    model = taq.build_model(DycoreConfig(**kw), CPU)
    before = [k.launches for k in WRAPPERS]
    got = state_to_numpy(model.run(state_from_numpy(start, CPU), 3))
    assert [k.launches for k in WRAPPERS] == before   # CPU: plain versions
    assert_within_gates(ref, got)
    # the moist processes acted: a flow, cloud and rain
    assert np.abs(got["u"]).max() > 0.1
    assert got["q"][..., 1].max() > 1e-4 and got["q"][..., 2].max() > 1e-5


@pytest.mark.parametrize("pallas_microphysics", [False, True])
def test_physics_alone_matches_jax(pallas_microphysics):
    kw = dict(KW, pallas_microphysics=pallas_microphysics)
    jm = jaq.build_model(JaxConfig(**kw))
    s = jm.step_fn(moist_start(jm))
    ref = _np(jm.physics_fn(s))
    model = taq.build_model(DycoreConfig(**kw), CPU)
    got = state_to_numpy(model.physics(state_from_numpy(_np(s), CPU)))
    assert_within_gates(ref, got)
    # one pass of physics from one state: far inside the whole-slice gate
    for f in ("u", "v", "pt"):
        assert np.abs(ref[f] - got[f]).max() <= 2e-5 * np.abs(ref[f]).max(), f
    assert np.array_equal(got["delp"], ref["delp"])


@pytest.fixture(scope="module")
def model():
    return taq.build_model(DycoreConfig(**KW), CPU)


def test_short_run_stable_and_moist(model):
    """tests/test_aquaplanet.py::test_short_run_stable_and_moist on the
    port, with the physical gates of the aquaplanet task."""
    st = model.init(perturb=0.01)
    s, hist = model.run_with_history(st, 12)
    s.check_f32()
    assert bool(s.pt.isfinite().all()) and bool(s.q.isfinite().all())
    qv = s.q[..., 0]
    assert float(qv.min()) > -1e-6 and float(qv.max()) < 0.05
    # surface evaporation must moisten the lowest layer somewhere
    assert float(qv.mean() - st.q[..., 0].mean()) > 0.0
    assert float(s.ps.min()) > 9.0e4 and float(s.ps.max()) < 1.1e5
    assert sorted(hist) == ["precip_total", "ps_mean", "qv_mean", "umax"]
    assert all(tuple(v.shape) == (12,) for v in hist.values())
    assert float(hist["qv_mean"][-1]) == pytest.approx(float(qv.mean()))
    assert float(hist["umax"][-1]) == float(s.u.abs().max())
    assert bool((hist["qv_mean"][1:] > hist["qv_mean"][:-1]).all())


def test_fused_flags_change_nothing_on_the_cpu(model):
    """On CPU tensors the kernel wrappers run their plain versions: the
    physics chain with pallas_microphysics=True is the eager one bit for
    bit."""
    fused = taq.build_model(DycoreConfig(**KW, pallas_microphysics=True),
                            CPU)
    s = model.run(model.init(perturb=3.0), 1)
    a, b = model.physics(s), fused.physics(s)
    for f in ("u", "v", "pt", "q"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_model_needs_three_tracers():
    with pytest.raises(ValueError, match="ntracers"):
        taq.build_model(DycoreConfig(npx=8, npz=12, ntracers=1), CPU)


@pytest.mark.parametrize("preset", ["aquaplanet_c48_l32",
                                    "aquaplanet_c48_l32_fused"])
def test_cli_runs_aquaplanet_presets_on_cpu(capsys, preset):
    from geosongpu_tpu_torch.cli import MODELS, PRESETS, main

    cfg = PRESETS[preset]
    assert MODELS[preset] == "aquaplanet"
    assert (cfg.npx, cfg.npz, cfg.dt, cfg.n_split, cfg.ntracers) \
        == (48, 32, 600.0, 6, 3)
    assert cfg.pallas_dycore == cfg.pallas_microphysics \
        == preset.endswith("_fused")
    assert main(["run", "--preset", preset, "--npx", "8", "--npz", "8",
                 "--steps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ms/step" in out and "mean qv" in out


def test_cli_physics_gate_on_cpu(capsys):
    from geosongpu_tpu_torch.cli import main

    assert main(["physics", "--kernel", "all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("5 datasets within 1e-04") == 7
    assert main(["physics", "--kernel", "Buoyancy", "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        main(["physics", "--kernel", "NoSuchKernel", "--device", "cpu"])

"""The JW06 baroclinic wave of the port (models/baroclinic_wave.py) against
the JAX package's, and the port's terrain (PaddedMetrics.phis).

- the initial state at c12-L26, balanced and perturbed: u, v, delp, pt
  and phis within 1 ulp of float32 of the reference's (both come from the
  same float64 numpy formulas);
- the padded phis of the port's context equal to the reference's
  padded_metrics(grid, phis=...) bit for bit, and nonzero;
- the discrete-balance gate of tests/test_baroclinic_wave.py on the port
  (c24-L26, dt 120, n_split 1: du/dt < 1e-3 m/s^2, column dps/dt < 0.5
  Pa/s), and its one-day steady gate (c24-L26, dt 900: max|ps - 1e5| <
  1,200 Pa, max|u| < 40 m/s; slow lane here, run on the card by
  chip_smoke.py);
- 3 steps at c12-L10 (dt 1200, n_split 2, perturbed) of the eager and the
  fused model against the JAX model of the same configuration, whose fused
  substep kernels run in interpret mode on the CPU.  The gates of
  tests/test_torch_model_fused.py: u, v within max(1e-4 x max|ref|, 6e-3
  m/s); delp, pt, ps within 1e-4 relative.  These are the CPU checks of
  c_sw_part2 and wind_part with nonzero phis, in the eager substep and in
  the plain versions of dsw_csw2 and dsw_wind;
- mass over those 3 steps (drift < 1e-5), run_with_history, and the CLI's
  JW06 preset at a small size.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.core.vertical import hybrid_coordinate  # noqa: E402
from geosongpu_tpu.dycore import sw as jsw  # noqa: E402
from geosongpu_tpu.models import baroclinic_wave as jbw  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.models import baroclinic_wave as tbw  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import dsw  # noqa: E402
from geosongpu_tpu_torch.ops.kernels.remap import remap_banded  # noqa: E402

CPU = torch.device("cpu")
GATE = 1e-4
WIND_ATOL = 6e-3
KW = dict(npx=12, npz=10, dt=1200.0, n_split=2, ntracers=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's models: the suite runs several
    workers on the same cores, and these small eager ops slow down by an
    order of magnitude when every worker starts a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def jax_c12_l26():
    return jbw.build_model(JaxConfig(npx=12, npz=26, ntracers=0))


@pytest.mark.parametrize("perturb", [False, True])
def test_initial_state_within_one_ulp(jax_c12_l26, perturb):
    jm = jax_c12_l26
    ref = _np(jm.init(perturb=perturb))
    model = tbw.build_model(DycoreConfig(npx=12, npz=26, ntracers=0), CPU)
    got = state_to_numpy(model.init(perturb=perturb))
    for f in ("u", "v", "delp", "pt", "phis", "ps"):
        assert got[f].dtype == np.float32 and got[f].shape == ref[f].shape, f
        np.testing.assert_array_max_ulp(ref[f], got[f], maxulp=1)
        print(f"{f}: {int((ref[f] != got[f]).sum())} elements differ")
    assert np.abs(got["phis"]).max() > 1e3       # terrain, not flat
    assert np.abs(got["u"]).max() > 30.0         # the 35 m/s jets


def test_padded_phis_bit_exact(jax_c12_l26):
    jm = jax_c12_l26
    cfg = DycoreConfig(npx=12, npz=26, ntracers=0)
    ak, bk = hybrid_coordinate(cfg.npz, cfg.ptop)
    _, phis = jbw.jw_initial_state(jm.config, jm.grid, np.asarray(ak),
                                   np.asarray(bk), perturb=False)
    ref = np.asarray(jsw.padded_metrics(jm.grid, phis=phis).phis)
    got = tbw.build_model(cfg, CPU).ctx.metrics.phis
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # halo cells carry the neighbouring faces' terrain
    assert float(np.abs(ref[:, :3]).min()) > 0.0


def test_discrete_balance():
    """One bare dynamics step of the balanced state (the reference's
    gate at c24: du/dt < 1e-3 m/s^2, column dps/dt < 0.5 Pa/s)."""
    cfg = DycoreConfig(npx=24, npz=26, dt=120.0, n_split=1, ntracers=0)
    m = tbw.build_model(cfg, CPU)
    s0 = m.init(perturb=False)
    s1 = m.dynamics(s0)
    dudt = float((s1.u - s0.u).abs().max()) / cfg.dt
    dpsdt = float((s1.delp - s0.delp).sum(-1).abs().max()) / cfg.dt
    assert dudt < 1.0e-3, f"du/dt {dudt:.2e} m/s^2"
    assert dpsdt < 0.5, f"column dps/dt {dpsdt:.2e} Pa/s"


@pytest.mark.slow
def test_steady_state_holds_one_day():
    """JW06 section 3 at c24-L26 (dt 900, n_split 6), the reference's gate
    of tests/test_baroclinic_wave.py: one day of the unperturbed state
    drifts by less than 1,200 Pa in ps, and the 35 m/s jet stays below 40
    m/s.  Slow: ~3 min on a CPU shared by the suite's workers;
    chip_smoke.py runs the same gate on the card."""
    m = tbw.build_model(DycoreConfig(npx=24, npz=26, dt=900.0, n_split=6,
                                     ntracers=0), CPU)
    s = m.run(m.init(perturb=False), 96)
    dev = float((s.ps - 1.0e5).abs().max())
    umax = float(s.u.abs().max())
    assert np.isfinite(dev)
    assert dev < 1200.0, f"steady-state ps drift {dev:.0f} Pa in 1 day"
    assert umax < 40.0, f"max|u| {umax:.1f} (initial jet is 35 m/s)"


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_three_steps_match_jax(fused):
    kw = dict(KW, pallas_dycore=fused)
    jm = jbw.build_model(JaxConfig(**kw))
    s = jm.init(perturb=True)
    start = _np(s)
    for _ in range(3):
        s = jm.step_fn(s)
    ref = _np(s)
    model = tbw.build_model(DycoreConfig(**kw), CPU)
    assert float(model.ctx.metrics.phis.abs().max()) > 1e3
    kernels = list(dsw.KERNELS) + [remap_banded]
    before = [k.launches for k in kernels]
    got = state_to_numpy(model.run(state_from_numpy(start, CPU), 3))
    assert [k.launches for k in kernels] == before   # the CPU launches none
    for f in ("u", "v", "delp", "pt", "ps"):
        a, b = ref[f], got[f]
        assert a.shape == b.shape and b.dtype == np.float32, f
        scale = float(np.abs(a).max())
        atol = WIND_ATOL if f in ("u", "v") else 0.0
        d = float(np.abs(a - b).max())
        print(f"{f}: max abs diff {d:.3e}, relative {d / scale:.3e}")
        assert d <= max(GATE * scale, atol), (f, d, scale)
    assert np.abs(got["u"] - start["u"]).max() > 0.01   # the flow moved


def test_mass_conserved_over_three_steps():
    model = tbw.build_model(DycoreConfig(**dict(KW, pallas_dycore=True)), CPU)
    w = np.asarray(model.grid.area)[model.grid.interior][..., None]
    s = model.init(perturb=True)
    m0 = float((w * s.delp.double().numpy()).sum())
    s = model.run(s, 3)
    m1 = float((w * s.delp.double().numpy()).sum())
    assert abs(m1 - m0) / m0 < 1e-5
    assert bool(s.u.isfinite().all()) and bool(s.pt.isfinite().all())


def test_run_with_history_records_ps_range():
    model = tbw.build_model(DycoreConfig(npx=8, npz=10, dt=1200.0,
                                         n_split=2, ntracers=0), CPU)
    s0 = model.init(perturb=True)
    end, hist = model.run_with_history(s0, 2)
    assert sorted(hist) == ["ps_max", "ps_min"]
    assert tuple(hist["ps_min"].shape) == (2,)
    want = model.run(s0, 2)
    assert torch.equal(end.u, want.u)
    assert float(hist["ps_min"][-1]) == float(want.ps.min())
    assert float(hist["ps_max"][-1]) == float(want.ps.max())


def test_cli_runs_jw_preset_on_cpu(capsys):
    from geosongpu_tpu_torch.cli import main

    assert main(["run", "--preset", "jw_baroclinic_c48_l26_fused", "--npx",
                 "8", "--npz", "10", "--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "c8-L10 on cpu" in out and "ms/step" in out

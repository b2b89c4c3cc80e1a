"""The multi-tracer form of fill_q2_zero and the kernel route of the
aquaplanet physics, on the CPU.

`fill_q2_zero_tracers(q, delp, n)` fills the first n tracers of the model
state's tracer array q [..., K, nq] in one launch of the fill kernel on a
card; on CPU tensors it runs the plain version tracer by tracer.  Here it
is held bit for bit to `fill_q2_zero` of each tracer slice, and to the
reference's `fill_q2_zero_pallas` (interpret mode) within 2e-6 of
max|reference| (the reference divides the deficit by delp as the port
does; measured 0.0).  Inputs from numpy, seeded: nq 3, n 1-3, K 2 and 32,
a leading shape of three axes.

Then the aquaplanet physics with pallas_microphysics=True: one call of the
multi-tracer fill and one of the cup_gf_sh wrapper per physics call, and
the chain within the gates of tests/test_torch_aquaplanet.py of the JAX
model's physics.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.models import aquaplanet as jaq  # noqa: E402
from geosongpu_tpu.ops.pallas.columns import \
    fill_q2_zero_pallas  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.models import aquaplanet as taq  # noqa: E402
from geosongpu_tpu_torch.ops.kernels import columns as kcolumns  # noqa: E402
from test_torch_aquaplanet import (KW, _np, assert_within_gates,  # noqa: E402
                                   moist_start)

LEAD = (2, 3, 5)
NQ = 3


def _tracers(K, seed):
    """q [2, 3, 5, K, 3] with negative values in every tracer, and a delp
    rising down the column, as numpy float32."""
    rng = np.random.default_rng(seed)
    q = rng.normal(1e-4, 3e-4, LEAD + (K, NQ)).astype(np.float32)
    dp = np.linspace(500.0, 2500.0, K, dtype=np.float32)
    delp = (dp * (1.0 + 0.2 * rng.random(LEAD + (K,)))).astype(np.float32)
    return q, delp


@pytest.mark.parametrize("K", [2, 32])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_tracer_form_equals_single_field_form(n, K):
    q, delp = _tracers(K, 10 * K + n)
    qt, dt = torch.from_numpy(q), torch.from_numpy(delp)
    before = kcolumns.fill_q2_zero.launches
    got = kcolumns.fill_q2_zero_tracers(qt, dt, n)
    assert kcolumns.fill_q2_zero.launches == before   # CPU: no launch
    assert len(got) == n
    for t, g in enumerate(got):
        want = kcolumns.fill_q2_zero(qt[..., t].contiguous(), dt)
        assert g.shape == LEAD + (K,) and g.dtype == torch.float32
        assert torch.equal(g, want), t
        assert bool((g >= 0).all())


@pytest.mark.parametrize("K", [2, 32])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_tracer_form_matches_pallas_interpret(n, K):
    q, delp = _tracers(K, 10 * K + n + 5)
    got = kcolumns.fill_q2_zero_tracers(torch.from_numpy(q),
                                        torch.from_numpy(delp), n)
    flat_dp = jnp.asarray(delp.reshape(-1, K))
    for t in range(n):
        ref = np.asarray(fill_q2_zero_pallas(
            jnp.asarray(q[..., t].reshape(-1, K)), flat_dp,
            interpret=True)).reshape(LEAD + (K,))
        err = np.abs(got[t].numpy() - ref).max()
        assert err <= 2e-6 * np.abs(ref).max(), (t, err)


def test_kernel_route_calls_each_wrapper_once(monkeypatch):
    """With pallas_microphysics the physics chain fills the three tracers
    in one call on the state's tracer array and mixes through the
    cup_gf_sh wrapper; without it, neither wrapper is called."""
    calls = []

    def spy(name):
        real = getattr(kcolumns, name)

        def wrapped(*a):
            calls.append(name)
            return real(*a)
        return wrapped

    for name in ("fill_q2_zero_tracers", "cup_gf_sh"):
        monkeypatch.setattr(kcolumns, name, spy(name))
    for flag, want in ((True, ["fill_q2_zero_tracers", "cup_gf_sh"]),
                       (False, [])):
        model = taq.build_model(
            DycoreConfig(**KW, pallas_microphysics=flag), torch.device("cpu"))
        calls.clear()
        model.physics(model.init(perturb=3.0))
        assert calls == want, flag


def test_kernel_route_physics_fills_undershoots_like_jax():
    """The physics chain alone, kernel route on the CPU, against the JAX
    model's physics (its Pallas microphysics in interpret mode) within the
    whole-slice gates, on a moist state whose three tracers all undershoot
    (each lowered by 1e-4 kg/kg after one step), so that the fill moves
    mass down every column where it acts."""
    kw = dict(KW, pallas_microphysics=True)
    jm = jaq.build_model(JaxConfig(**kw))
    s = _np(jm.step_fn(moist_start(jm)))
    s["q"] = s["q"] - np.float32(1e-4)
    assert all((s["q"][..., n] < 0).any() for n in range(3))
    ref = _np(jm.physics_fn(jaq.DycoreState(
        **{k: jnp.asarray(v) for k, v in s.items()})))
    model = taq.build_model(DycoreConfig(**kw), torch.device("cpu"))
    got = state_to_numpy(model.physics(state_from_numpy(s, "cpu")))
    assert_within_gates(ref, got)
    assert got["q"].min() >= -1e-6

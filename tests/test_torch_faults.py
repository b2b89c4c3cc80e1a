"""Held-Suarez run_with_history and the options the port refuses.

run_with_history: 3 steps at c8-L8 (dt 1200, n_split 2, hord_tm 6, one
tracer) from one state (3 K of pt noise and one reference step, so that
the flow is not at rest), in the port and in the JAX model; the final
state within the gates of tests/test_torch_model.py (u, v within
max(1e-4 x max|ref|, 6e-3 m/s), the rest within 1e-4 relative), and each
step's ps_mean, ps_min, ps_max and tmean within 1e-4 relative, umax like
the winds.

check_supported: a kord other than 8, and hord, hord_tm or hord_mt
outside {6, 8} (0 follows hord for the last two) fail when the model is
built, each named in the message.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model as jax_model  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.core.state import (state_from_numpy,  # noqa: E402
                                            state_to_numpy)
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402

CPU = torch.device("cpu")
KW = dict(npx=8, npz=8, dt=1200.0, n_split=2, hord_tm=6, ntracers=1)
GATE = 1e-4
WIND_ATOL = 6e-3
DIAGNOSTICS = ("ps_mean", "ps_min", "ps_max", "umax", "tmean")


def _np(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def test_run_with_history_matches_jax():
    jm = jax_model(JaxConfig(**KW))
    s = jm.init(perturb=3.0)
    rng = np.random.default_rng(5)
    q = (1.0 + 0.2 * rng.random(s.q.shape)).astype(np.float32)
    s = jm.step_fn(dataclasses.replace(s, q=jnp.asarray(q)))
    start = _np(s)
    ref_state, ref_hist = jm.run_with_history(s, 3)
    ref = _np(ref_state)

    got_state, hist = build_model(DycoreConfig(**KW), CPU).run_with_history(
        state_from_numpy(start, CPU), 3)
    got = state_to_numpy(got_state)
    for f in ("u", "v", "delp", "pt", "q", "ps"):
        scale = float(np.abs(ref[f]).max())
        atol = WIND_ATOL if f in ("u", "v") else 0.0
        d = float(np.abs(ref[f] - got[f]).max())
        assert d <= max(GATE * scale, atol), (f, d, scale)
    assert tuple(hist) == DIAGNOSTICS
    for name in DIAGNOSTICS:
        r = np.asarray(ref_hist[name])
        g = hist[name].numpy()
        assert g.shape == r.shape == (3,) and g.dtype == np.float32, name
        atol = WIND_ATOL if name == "umax" else 0.0
        d = float(np.abs(r - g).max())
        assert d <= max(GATE * float(np.abs(r).max()), atol), (name, d)
    # the last row is the returned state's
    assert float(hist["ps_max"][-1]) == float(got_state.ps.max())
    assert float(hist["umax"][-1]) > 0.1


@pytest.mark.parametrize("option,value,message", [
    ("kord", 6, "kord=6"),
    ("hord", 5, "hord=5"),
    ("hord", 0, "hord=0"),
    ("hord_tm", 7, "hord_tm=7"),
    ("hord_mt", 10, "hord_mt=10"),
])
def test_unported_options_fail_when_the_model_is_built(option, value,
                                                       message):
    cfg = dataclasses.replace(DycoreConfig(npx=8, npz=6), **{option: value})
    with pytest.raises(NotImplementedError, match=message):
        build_model(cfg, CPU)


@pytest.mark.parametrize("option", ["hord_tm", "hord_mt"])
def test_zero_follows_hord(option):
    cfg = dataclasses.replace(DycoreConfig(npx=8, npz=6, hord=6),
                              **{option: 0})
    assert build_model(cfg, CPU).config.hord == 6

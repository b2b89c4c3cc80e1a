"""The c192 rung of scripts/bench_ladder.py is unstable with its n_split 6,
in the JAX package and in the port alike; n_split 8 is stable.

bench.py's configuration (dt 600 s, n_split 6) gives an acoustic substep of
100 s, which at c192 (cells of 37-52 km) exceeds the horizontal stability
limit of the forward-backward substep: from 1e-3 K of pt noise every field
is non-finite within 8 steps.  bench.py does not look at its fields, so the
rung runs to its end on non-finite states.  The port's preset
held_suarez_c192_l72_fused therefore takes n_split 8.

This runs both packages at c192-L8 on the CPU (the instability is
horizontal, so 8 levels show it; about 2 minutes and a few GB), hence the
`slow` marker: it records where PERF.md's and ROADMAP.md's statement comes
from and is not part of the quick lane.

    python -m pytest tests/test_torch_c192_stability.py -m slow -n 0 -s
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from geosongpu_tpu.core.config import DycoreConfig as JaxConfig  # noqa: E402
from geosongpu_tpu.models.held_suarez import build_model as jax_model  # noqa: E402
from geosongpu_tpu_torch.core.config import DycoreConfig  # noqa: E402
from geosongpu_tpu_torch.models.held_suarez import build_model  # noqa: E402

STEPS = 8


def _kw(n_split):
    return dict(npx=192, npz=8, dt=600.0, n_split=n_split, hord_tm=6)


def _jax_umax(n_split):
    jm = jax_model(JaxConfig(**_kw(n_split)))
    s = jm.init(perturb=1e-3)
    out = []
    for _ in range(STEPS):
        s = jm.step_fn(s)
        out.append(float(jnp.abs(s.u).max()))
    return out


def _torch_umax(n_split):
    model = build_model(DycoreConfig(**_kw(n_split)), torch.device("cpu"))
    s = model.init(perturb=1e-3)
    out = []
    for _ in range(STEPS):
        s = model.step(s)
        out.append(float(s.u.abs().max()))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("run", [_jax_umax, _torch_umax],
                         ids=["jax", "torch"])
def test_c192_n_split_6_goes_non_finite_and_8_stays_finite(run):
    bad = run(6)
    print(f"{run.__name__} n_split 6 max|u| per step: {bad}")
    assert not np.isfinite(bad[-1])
    good = run(8)
    print(f"{run.__name__} n_split 8 max|u| per step: {good}")
    assert np.isfinite(good).all() and max(good) < 1.0

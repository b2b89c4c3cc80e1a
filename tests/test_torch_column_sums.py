"""The premise of reordering the column sums of the hydrostatic column stage.

The CUDA column stage (csrc/dsw_common.cuh, hydro_columns) and the plain
version's cumsum_k (ops/vertical.py) both sum the float32 layer values of a
column in float64 and round once.  A scan or a tiled sum adds the same values
in another order.  That cannot change a bit as long as every partial sum is
exact in float64, which holds when the float32 values of one column span far
fewer than 53 - 24 binary orders of magnitude less log2(K).  These tests hold
that premise on the start states of the presets' vertical grids (L72, L32) and
of the small sizes the other tests run (L8, L12), for both sums of the stage:
delp (the interface pressures) and cp pt dpk (the geopotential).  For every
column, every prefix and every suffix, the float64 sum taken top-down,
bottom-up and pairwise is the same, and equals the exact rational sum.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geosongpu_tpu_torch.cli import PRESETS, build_model_for  # noqa: E402
from geosongpu_tpu_torch.core.grid import CP_AIR, KAPPA  # noqa: E402
from geosongpu_tpu_torch.dycore.sw import P00  # noqa: E402
from geosongpu_tpu_torch.ops.vertical import (cumsum_k,  # noqa: E402
                                              interfaces_from_delp,
                                              rcumsum_k)

# (preset, npx, npz): the presets' own vertical grids at a narrow width, and
# the small sizes of the card-vs-CPU runs
SIZES = [("held_suarez_c48_l72_fused", 8, 72),
         ("held_suarez_c48_l72_nh_fused", 8, 72),
         ("aquaplanet_c48_l32_fused", 8, 32),
         ("held_suarez_c48_l72_fused", 12, 8),
         ("aquaplanet_c48_l32_fused", 8, 12)]
IDS = [f"{p}-c{npx}-L{npz}" for p, npx, npz in SIZES]


def _layers(preset, npx, npz):
    """{name: float32 [columns, K]} of the two summands of the column stage
    on the preset's start state (3 K of pt noise)."""
    cfg = dataclasses.replace(PRESETS[preset], npx=npx, npz=npz)
    st = build_model_for(preset)(cfg, torch.device("cpu")).init(perturb=3.0)
    pe = interfaces_from_delp(st.delp, cfg.ptop)
    pk = (pe / P00) ** KAPPA
    dphi = CP_AIR * st.pt * (pk[..., 1:] - pk[..., :-1])
    assert st.delp.dtype == dphi.dtype == torch.float32
    return {"delp": st.delp.reshape(-1, npz).numpy(),
            "cp_pt_dpk": dphi.reshape(-1, npz).numpy()}


@pytest.fixture(scope="module", params=SIZES, ids=IDS)
def layers(request):
    return request.param, _layers(*request.param)


def _pairwise(x):
    """Sum along the last axis by halving, in float64."""
    if x.shape[-1] == 1:
        return x[..., 0]
    h = x.shape[-1] // 2
    return _pairwise(x[..., :h]) + _pairwise(x[..., h:])


def _sequential(x):
    s = np.zeros(x.shape[:-1], np.float64)
    for k in range(x.shape[-1]):
        s = s + x[..., k]
    return s


@pytest.mark.parametrize("name", ["delp", "cp_pt_dpk"])
def test_column_sums_do_not_depend_on_order(layers, name):
    _, fields = layers
    x = fields[name].astype(np.float64)
    K = x.shape[-1]
    assert np.isfinite(x).all()
    for n in range(1, K + 1):
        for part in (x[:, :n], x[:, K - n:]):     # a prefix and a suffix
            down = _sequential(part)
            up = _sequential(part[:, ::-1])
            pair = _pairwise(part)
            assert np.array_equal(down, up), (name, n)
            assert np.array_equal(down, pair), (name, n)


@pytest.mark.parametrize("name", ["delp", "cp_pt_dpk"])
def test_column_sums_are_exact_in_float64(layers, name):
    """The float64 sum of a column's float32 values is the exact sum, on a
    sample of columns: nothing is rounded, so no order can differ."""
    _, fields = layers
    x = fields[name]
    rng = np.random.default_rng(0)
    for c in rng.choice(x.shape[0], size=min(40, x.shape[0]), replace=False):
        exact = sum(Fraction(float(v)) for v in x[c])
        assert Fraction(float(x[c].astype(np.float64).sum())) == exact


@pytest.mark.parametrize("name", ["delp", "cp_pt_dpk"])
def test_cumsum_k_is_the_sequential_double_sum(layers, name):
    """cumsum_k and rcumsum_k, the plain version's sums, equal the running
    float64 sum in the column stage's order, rounded once to float32."""
    _, fields = layers
    x = fields[name]
    run = np.cumsum(x.astype(np.float64), axis=-1).astype(np.float32)
    assert np.array_equal(cumsum_k(torch.from_numpy(x)).numpy(), run)
    rrun = np.cumsum(x[:, ::-1].astype(np.float64),
                     axis=-1).astype(np.float32)[:, ::-1]
    assert np.array_equal(rcumsum_k(torch.from_numpy(x.copy())).numpy(), rrun)


def test_the_premise_fails_where_it_should():
    """A column whose values span more than float64 holds is order
    dependent: the check above is able to fail."""
    x = np.array([[1.0e30, 1.0, -1.0e30, 1.0]], np.float32).astype(np.float64)
    assert not np.array_equal(_sequential(x), _pairwise(x))

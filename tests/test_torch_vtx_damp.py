"""vtx_damp = 0 is inert in the port's wind update.

The rotational damping channel reads the relative vorticity zeta =
vort - fcor, and the wind update given the chart-corrected vorticity reads
fcor nowhere else.  So with vtx_damp = 0 the update must not read fcor at
all: poisoning fcor with NaN leaves it bit for bit unchanged, while with
vtx_damp > 0 the NaN reaches the winds (the check can see the channel).
This is the inertness that tests/test_vorticity_damping.py claims for the
JAX package; the plain version of dsw_wind is the eager wind_part of
dycore/sw.py.
"""
import numpy as np
import pytest
import torch

from geosongpu_tpu_torch.core.config import DycoreConfig
from geosongpu_tpu_torch.dycore.fv_dynamics import _use_exchange
from geosongpu_tpu_torch.dycore.sw import fill_substep
from geosongpu_tpu_torch.dycore.sw_fused import substep_kernel_args
from geosongpu_tpu_torch.models.held_suarez import build_model
from geosongpu_tpu_torch.ops.kernels.dsw import dsw_wind_plain


@pytest.mark.parametrize("damping", ["exchange", "blend"])
def test_vtx_damp_zero_does_not_read_the_vorticity(damping):
    torch.set_num_threads(1)
    cfg = DycoreConfig(npx=8, npz=4, dt=600.0, n_split=2,
                       damping_exchange=damping)
    model = build_model(cfg, torch.device("cpu"))
    ctx = model.ctx
    st = model.run(model.init(perturb=3.0), 1)
    s = fill_substep(ctx.ops, st.u, st.v, st.delp, st.pt, chart=ctx.chart)
    args, _ = substep_kernel_args(
        s, ctx.metrics, ctx.ops, cfg.dt / cfg.n_split, cfg.ptop,
        hord=cfg.hord, d2_bg=cfg.d2_bg, advect_tracers=False,
        hord_mt=cfg.hord_mt, hord_tm=cfg.hord_tm, chart=ctx.chart,
        stag_tabs=ctx.stag if _use_exchange(cfg) else None, vtx_damp=0.0)
    a = list(args["dsw_wind"])
    assert a[13] == 0.0
    want = dsw_wind_plain(*a)
    a[8] = a[8]._replace(fcor=torch.full_like(a[8].fcor, float("nan")))
    got = dsw_wind_plain(*a)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    a[13] = 0.05
    assert not all(bool(torch.isfinite(g).all())
                   for g in dsw_wind_plain(*a))
    assert np.isfinite(want[0].numpy()).all()

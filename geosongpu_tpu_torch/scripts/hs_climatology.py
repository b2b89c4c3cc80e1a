"""Held-Suarez climatology run on the port (the counterpart of
scripts/hs_climatology.py, with its configuration and diagnostics).

    python -m geosongpu_tpu_torch.scripts.hs_climatology [--npx 24]
        [--npz 20] [--days 200] [--spinup 50] [--dt 900] [--device cuda|cpu]
        [--out hs_climatology.png] [--npz_out hs_climatology.npz]

Integrates the dycore with HS94 forcing (n_split 6) through `--spinup`
days, then averages the zonal-mean zonal wind and temperature in 32
latitude bins, four samples a day, until day `--days`.  HS94 shows
midlatitude westerly jets (~25-30 m/s near sigma ~0.25) and tropical
surface easterlies.  Writes the means to `--npz_out`, prints the jet and
tropical numbers and draws the figure; the figure needs matplotlib, which
the card's machine does not have: there call `climatology` and draw the
npz elsewhere.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import card_line, device_of

NBINS = 32


def climatology(model, state, days: float, spinup: float):
    """(ubar, tbar, edges, nsamp): `spinup` days of steps from `state`,
    then the time means of the zonal-mean ua and T [NBINS, npz] over
    latitude bins `edges` (radians), sampled four times a day until day
    `days`."""
    from ..dycore.fv_dynamics import exner_mid

    cfg = model.config
    steps_per_day = int(86400.0 / cfg.dt)
    spin_steps = int(spinup * steps_per_day)
    avg_steps = int((days - spinup) * steps_per_day)
    print(f"c{cfg.npx}-L{cfg.npz} on {card_line(model.device)}: spinup "
          f"{spin_steps} steps + average over {avg_steps}", flush=True)
    t0 = time.time()
    state = model.run(state, spin_steps)

    lat = model.lats.lat_c.cpu().numpy()
    edges = np.linspace(-np.pi / 2, np.pi / 2, NBINS + 1)
    bin_idx = np.clip(np.digitize(lat.ravel(), edges) - 1, 0, NBINS - 1)
    usum = np.zeros((NBINS, cfg.npz))
    tsum = np.zeros((NBINS, cfg.npz))
    nsamp = 0
    sample_every = steps_per_day // 4 or 1
    while nsamp * sample_every < avg_steps:
        state = model.run(state, sample_every)
        ua = state.ua.cpu().numpy().reshape(-1, cfg.npz)
        tt = (state.pt * exner_mid(state.delp, cfg.ptop)).cpu().numpy(
        ).reshape(-1, cfg.npz)
        for b in range(NBINS):
            sel = bin_idx == b
            if sel.any():
                usum[b] += ua[sel].mean(0)
                tsum[b] += tt[sel].mean(0)
        nsamp += 1
        if nsamp % 40 == 0:
            print(f"  averaging sample {nsamp} ({time.time() - t0:.0f}s)",
                  flush=True)
    return usum / max(nsamp, 1), tsum / max(nsamp, 1), edges, nsamp


def jet_and_tropics(ubar, edges):
    """(midlatitude upper-level jet max, tropical near-surface mean u) in
    m/s: the HS94 headline checks."""
    latc = np.degrees(0.5 * (edges[:-1] + edges[1:]))
    npz = ubar.shape[1]
    mid = (np.abs(latc) > 25) & (np.abs(latc) < 65)
    jet = ubar[mid][:, :max(1, int(0.4 * npz))].max()
    trop = ubar[np.abs(latc) < 15][:, -3:].mean()
    return float(jet), float(trop)


def main(argv=None) -> int:
    from ..core.config import DycoreConfig
    from ..models.held_suarez import build_model

    p = argparse.ArgumentParser(prog="hs_climatology")
    p.add_argument("--npx", type=int, default=24)
    p.add_argument("--npz", type=int, default=20)
    p.add_argument("--days", type=float, default=200.0)
    p.add_argument("--spinup", type=float, default=50.0)
    p.add_argument("--dt", type=float, default=900.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default="hs_climatology.png")
    p.add_argument("--npz_out", default="hs_climatology.npz")
    args = p.parse_args(argv)

    cfg = DycoreConfig(npx=args.npx, npz=args.npz, dt=args.dt, n_split=6)
    model = build_model(cfg, device_of(args.device))
    ubar, tbar, edges, nsamp = climatology(
        model, model.init(perturb=0.1), args.days, args.spinup)
    np.savez_compressed(args.npz_out, ubar=ubar, tbar=tbar, lat_edges=edges,
                        nsamp=nsamp)
    jet, trop = jet_and_tropics(ubar, edges)
    print(f"jet max (midlat, upper): {jet:.1f} m/s (HS94 ~ 25-30); tropical "
          f"surface u: {trop:.1f} m/s (expect < 0)", flush=True)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    latc = np.degrees(0.5 * (edges[:-1] + edges[1:]))
    sigma = (np.arange(cfg.npz) + 0.5) / cfg.npz
    fig, axes = plt.subplots(1, 2, figsize=(13, 5))
    cs = axes[0].contourf(latc, sigma, ubar.T, levels=15, cmap="RdBu_r")
    axes[0].invert_yaxis()
    axes[0].set_title("time/zonal-mean u [m/s]")
    axes[0].set_xlabel("latitude")
    axes[0].set_ylabel("sigma")
    fig.colorbar(cs, ax=axes[0])
    cs2 = axes[1].contourf(latc, sigma, tbar.T, levels=15, cmap="viridis")
    axes[1].invert_yaxis()
    axes[1].set_title("time/zonal-mean T [K]")
    axes[1].set_xlabel("latitude")
    fig.colorbar(cs2, ax=axes[1])
    fig.suptitle(f"Held-Suarez c{args.npx}-L{args.npz}, "
                 f"days {args.spinup}-{args.days}")
    fig.savefig(args.out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {args.out} and {args.npz_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

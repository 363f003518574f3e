#!/usr/bin/env python3
"""One-route diagnostic for the VIO backend-event (snap) model.

Runs teach+repeat on a single route and prints the timeline the calibration
loop needs: where backend events fire, how the nav error evolves between
anchors, where the dispatcher stalls, and what the live costmap did.

    python tools/diag_snap.py --route 02_north_forest --mode ours \
        [--ticks 12000] [--platform cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", default="02_north_forest")
    ap.add_argument("--mode", default="ours")
    ap.add_argument("--ticks", type=int, default=12000)
    ap.add_argument("--teach-ticks", type=int, default=12000)
    ap.add_argument("--platform", default=None, choices=["cpu"],
                    help="force the CPU (default: JAX's choice, the GPU)")
    args = ap.parse_args()

    from nclt_slam_tpu.runtime import init_runtime

    init_runtime(args.platform)
    import numpy as np

    from nclt_slam_tpu.cli.common import MODES
    from nclt_slam_tpu.rollout.campaign import (
        build_campaign, run_campaign_repeat, run_campaign_teach,
        teach_waypoints, campaign_metrics)

    cfg = MODES[args.mode]()
    data = build_campaign([args.route], cfg=cfg)
    teach = run_campaign_teach(data, cfg, args.teach_ticks)
    wps, n_wps = teach_waypoints(data, teach, cfg)
    rep = run_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg,
                              args.ticks, stores=teach.store)
    per_route, agg = campaign_metrics(data, rep, wps, n_wps, cfg)

    tr = rep.trace
    gt = np.asarray(tr.gt_xy)[0]
    nav = np.asarray(tr.nav_xy)[0]
    vio = np.asarray(tr.vio_xy)[0]
    flags = np.asarray(tr.vio_flags)[0]
    done = np.asarray(tr.done)[0]
    wp_idx = np.asarray(tr.wp_idx)[0]
    regime = np.asarray(tr.regime)[0]
    ok = np.asarray(tr.anchor_ok)[0]
    ndesc = np.asarray(tr.vio_ndesc)[0]
    ntrk = np.asarray(tr.vio_tracked)[0]

    err = np.hypot(*(nav - gt).T)
    fire = (flags >> 5) & 1
    lost = (flags >> 3) & 1
    n_live = int((~done).sum())
    print(f"route {args.route} mode {args.mode}: live ticks {n_live}, "
          f"done at {np.argmax(done) if done.any() else -1}")
    m = per_route[args.route]
    print({k: (round(v, 2) if isinstance(v, float) else v)
           for k, v in m.items()})
    print(f"events fired: {int(fire[:n_live].sum())} at ticks "
          f"{np.flatnonzero(fire[:n_live])[:40].tolist()}")
    print(f"lost frames: {int(lost[:n_live].sum())}, "
          f"n_tracked p10/p50 {np.percentile(ntrk[:n_live], 10):.0f}/"
          f"{np.percentile(ntrk[:n_live], 50):.0f}")
    print("tick  err   wp  regime anchors(last500) fired(last500) v_med")
    cmd_v = np.asarray(tr.cmd_v)[0]
    for t0 in range(0, n_live, 500):
        sl = slice(t0, min(t0 + 500, n_live))
        print(f"{t0:5d} {err[sl].mean():5.2f} {wp_idx[sl][-1]:4d} "
              f"{np.bincount(regime[sl][regime[sl] >= 0], minlength=4).tolist()}"
              f" {int(ok[sl].sum()):3d} {int(fire[sl].sum()):3d}"
              f" {np.median(cmd_v[sl]):5.2f}")


if __name__ == "__main__":
    main()

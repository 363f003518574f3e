"""Campaign CLI — the run_all_{teach,repeat}.sh + compute_metrics equivalent,
as ONE batched program.

    python -m nclt_slam_tpu.cli.campaign --routes all --mode ours --out /tmp/camp

Teaches every route (vmapped), repeats every route with obstacle drops
(vmapped), prints the reference's per-route + aggregate markdown tables and
writes metrics.json.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--routes", default="all",
                    help="'all' or comma-separated route names")
    ap.add_argument("--mode", default="ours",
                    choices=["ours", "gt", "encoder", "rgbd", "stock"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--teach-ticks", type=int, default=12000)
    ap.add_argument("--repeat-ticks", type=int, default=12000)
    ap.add_argument("--no-obstacles", dest="obstacles", action="store_false",
                    default=True)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--figures", action="store_true",
                    help="render per-route run figures + summary heatmap")
    ap.add_argument("--route-slice", default=None,
                    help="A:B batch slice for the repeat phase (sub-batch "
                         "fallback when the full-width program is unstable)")
    ap.add_argument("--phase", default="both",
                    choices=["both", "teach", "repeat"],
                    help="run one phase and checkpoint (worker-crash "
                         "resilience: phases retry as separate processes)")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    from nclt_slam_tpu.runtime import init_runtime

    init_runtime(args.platform)

    from nclt_slam_tpu.cli.common import config_for, write_metrics
    from nclt_slam_tpu.rollout.campaign import (
        CampaignData,
        build_campaign,
        campaign_metrics,
        run_campaign_repeat,
        run_campaign_teach,
        teach_waypoints,
    )
    from nclt_slam_tpu.scene.routes import ALL_ROUTES

    names = ALL_ROUTES if args.routes == "all" else args.routes.split(",")
    cfg_teach = config_for("gt", args.scale)
    cfg = config_for(args.mode, args.scale)

    print(f"[campaign] {len(names)} routes, mode={args.mode}", flush=True)
    data = build_campaign(names, cfg=cfg, with_drops=args.obstacles)

    def prog(tag):
        def f(done_ticks, total, n_done):
            print(f"[campaign] {tag} {done_ticks}/{total} ticks, "
                  f"{n_done}/{len(names)} routes complete", flush=True)
        return f

    from pathlib import Path

    from nclt_slam_tpu.io.artifacts import load_checkpoint, save_checkpoint

    ckpt = Path(args.out) / "teach_state.ckpt"
    if args.phase in ("both", "teach"):
        teach = run_campaign_teach(data, cfg_teach, args.teach_ticks,
                                   progress=prog("teach"))
        wps, n_wps = teach_waypoints(data, teach, cfg)
        save_checkpoint(
            {"grid": teach.teach_grid, "store": teach.store,
             "wps": wps, "n_wps": n_wps}, ckpt)
        print(f"[campaign] teach checkpoint -> {ckpt}", flush=True)
        if args.phase == "teach":
            return 0
        teach_grid, stores = teach.teach_grid, teach.store
    else:
        blob = load_checkpoint(ckpt)
        teach_grid, stores = blob["grid"], blob["store"]
        wps, n_wps = blob["wps"], blob["n_wps"]
        print(f"[campaign] teach checkpoint loaded <- {ckpt}", flush=True)

    if args.mode == "gt":
        stores = None
    if args.route_slice:
        import jax.tree_util as jtu

        a, b = (int(v) if v else None for v in args.route_slice.split(":"))
        sl = slice(a, b)
        data = CampaignData(
            scenes_teach=jtu.tree_map(lambda x: x[sl], data.scenes_teach),
            scenes_repeat=jtu.tree_map(lambda x: x[sl], data.scenes_repeat),
            routes=jtu.tree_map(lambda x: x[sl], data.routes),
            names=data.names[sl])
        teach_grid = teach_grid[sl]
        wps, n_wps = wps[sl], n_wps[sl]
        if stores is not None:
            stores = jtu.tree_map(lambda x: x[sl], stores)
        names = list(data.names)
        print(f"[campaign] repeat slice {args.route_slice}: {names}",
              flush=True)
    rep = run_campaign_repeat(data, teach_grid, wps, n_wps, cfg,
                              args.repeat_ticks, stores=stores,
                              progress=prog("repeat"))

    per_route, agg = campaign_metrics(data, rep, wps, n_wps, cfg)

    # reference-style markdown tables (compute_metrics.py main)
    print("\n# Per-route GT-based metrics\n")
    print("| route | coverage | final reach | return | "
          "drift (mean / p95 / max) | GT samples |")
    print("|---|---|---|---|---|---|")
    for name, x in per_route.items():
        cov = (f"{x['cov_visited']}/{x['cov_total']} ({x['cov_pct']:.0f}%)"
               if x["cov_pct"] is not None else "n/a")
        final = (f"**{x['final_d']:.1f} m** "
                 f"{'OK' if x['reached_final'] else 'x'}")
        ret = (f"**{x['return_d']:.1f} m** "
               f"{'OK' if x['returned_spawn'] else 'x'}")
        drift = (f"{x['drift_mean']:.2f} / {x['drift_p95']:.2f} / "
                 f"{x['drift_max']:.2f} m" if x["drift_mean"] is not None
                 else "n/a")
        print(f"| {name} | {cov} | {final} | {ret} | {drift} | "
              f"{x['gt_samples']} |")

    print("\n# Aggregate\n")
    print("| routes | reach | return | full success | avg coverage | "
          "avg drift |")
    print("|---|---|---|---|---|---|")
    print(f"| {agg['routes']} | {agg['reach']}/{agg['routes']} | "
          f"{agg['return']}/{agg['routes']} | "
          f"{agg['full_success']}/{agg['routes']} | "
          f"{agg['avg_coverage_pct']:.0f}% | "
          f"{agg['avg_drift_mean']:.2f} m |")

    p = write_metrics(args.out, {"per_route": per_route, "aggregate": agg})
    print(f"\n(machine-readable -> {p})")

    # structured trace archive: what cli.analyze renders the thesis-figure
    # zoo from (the reference scrapes per-process logs instead)
    import numpy as np
    from pathlib import Path as _P

    tr = rep.trace
    np.savez_compressed(
        _P(args.out) / "traces.npz",
        gt_xy=np.asarray(tr.gt_xy), nav_xy=np.asarray(tr.nav_xy),
        regime=np.asarray(tr.regime), anchor_ok=np.asarray(tr.anchor_ok),
        wp_idx=np.asarray(tr.wp_idx), done=np.asarray(tr.done),
        fired=np.asarray(tr.fired), wps=np.asarray(wps),
        n_wps=np.asarray(n_wps), names=np.array(list(data.names)),
        vio_tracked=np.asarray(tr.vio_tracked),
        vio_flags=np.asarray(tr.vio_flags))
    print(f"(traces -> {_P(args.out) / 'traces.npz'})")

    if args.figures:
        import jax.tree_util as jtu

        from nclt_slam_tpu.analysis import (
            plot_campaign_summary,
            plot_drift,
            plot_route_run,
        )
        from pathlib import Path

        figs = Path(args.out) / "figures"
        plot_campaign_summary(per_route, figs / "campaign_summary.png")
        for i, name in enumerate(names):
            tr_i = jtu.tree_map(lambda x: x[i], rep.trace)
            sc_i = jtu.tree_map(lambda x: x[i], data.scenes_repeat)
            rt_i = jtu.tree_map(lambda x: x[i], data.routes)

            class _R:  # route-view for the plotting API
                dense_xy = rt_i.dense_xy
                n_dense = int(rt_i.n_dense)
                spawn = tuple(map(float, rt_i.spawn))
                turnaround = tuple(map(float, rt_i.turnaround))
                name = names[i]

            plot_route_run(sc_i, _R, tr_i, wps[i], int(n_wps[i]),
                           figs / f"run_{name}.png")
            plot_drift(tr_i, figs / f"drift_{name}.png",
                       title=f"drift — {name}")
        print(f"[campaign] figures -> {figs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

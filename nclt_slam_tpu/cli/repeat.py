"""Repeat-pass CLI — the run_repeat_ours.sh equivalent.

    python -m nclt_slam_tpu.cli.repeat --route 03_south \
        --teach-dir /tmp/tr/03_south/teach --out /tmp/tr/03_south/repeat

Loads the teach artefacts (map, landmarks, dense poses), runs the repeat
rollout with the chosen localization stack and obstacle drops, writes
traj_gt.csv / nav_pose.csv / metrics.json.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--route", default="03_south")
    ap.add_argument("--teach-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", default="ours",
                    choices=["ours", "gt", "encoder", "rgbd", "stock"])
    ap.add_argument("--obstacles", action="store_true", default=True)
    ap.add_argument("--no-obstacles", dest="obstacles", action="store_false")
    ap.add_argument("--ticks", type=int, default=12000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    from nclt_slam_tpu.runtime import init_runtime

    init_runtime(args.platform)

    import jax

    import numpy as np

    from nclt_slam_tpu.cli.common import (
        config_for,
        write_metrics,
        write_repeat_artifacts,
    )
    from nclt_slam_tpu.eval.metrics import route_metrics, subsample_wps
    from nclt_slam_tpu.io.artifacts import (
        load_landmarks_pkl,
        load_teach_map,
        load_vio_pose_dense,
    )
    from nclt_slam_tpu.planning.dispatcher import subsample_waypoints
    from nclt_slam_tpu.rollout import pack_route, pack_scene, run_repeat
    from nclt_slam_tpu.scene import build_drops, default_scene, get_route

    cfg = config_for(args.mode, args.scale)
    route = get_route(args.route)
    drops = build_drops(route) if args.obstacles else None
    scene = pack_scene(default_scene(), drops, session=1)
    packed = pack_route(route, cfg)

    teach_dir = Path(args.teach_dir)
    grid, _, _ = load_teach_map(teach_dir / "teach_map")
    store = load_landmarks_pkl(teach_dir / "landmarks.pkl", cfg.landmarks)
    dense_gt = load_vio_pose_dense(teach_dir / "vio_pose_dense.csv")
    wps, n_wps = subsample_waypoints(dense_gt, len(dense_gt), cfg.planner)

    import jax.numpy as jnp

    print(f"[repeat] {args.route} mode={args.mode} obstacles={args.obstacles} "
          f"wps={n_wps} landmarks={int(store.count)}")
    rep = jax.jit(lambda: run_repeat(
        scene, packed, jnp.asarray(grid), wps, n_wps, cfg, args.ticks,
        seed=args.seed, store=store))()

    out = write_repeat_artifacts(args.out, rep, cfg)
    gt = np.asarray(rep.trace.gt_xy)
    nav = np.asarray(rep.trace.nav_xy)
    m = route_metrics(gt, nav, wps[:n_wps], route.spawn, route.turnaround,
                      wp_tol=cfg.eval.wp_tol_m,
                      endpoint_tol=cfg.eval.endpoint_tol_m,
                      drift_period=cfg.eval.drift_log_period)
    write_metrics(out, m)
    print(f"[repeat] coverage {m['cov_visited']}/{m['cov_total']} "
          f"reach={m['reached_final']} ({m['final_d']:.1f} m) "
          f"return={m['returned_spawn']} ({m['return_d']:.1f} m) "
          f"drift={m['drift_mean']:.2f} m")
    print(f"[repeat] artefacts -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Teach-pass CLI — the run_teach.sh equivalent.

    python -m nclt_slam_tpu.cli.teach --route 03_south --out /tmp/tr/03_south/teach

Writes the reference artefact set: teach_map.{pgm,yaml}, landmarks.pkl,
vio_pose_dense.csv, traj_gt.csv.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--route", default="03_south")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ticks", type=int, default=9000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="sensor resolution scale (CPU debugging)")
    ap.add_argument("--platform", default=None,
                    help="force jax platform (e.g. cpu)")
    args = ap.parse_args(argv)

    from nclt_slam_tpu.runtime import init_runtime

    init_runtime(args.platform)

    import jax

    from nclt_slam_tpu.cli.common import config_for, write_teach_artifacts
    from nclt_slam_tpu.rollout import pack_route, pack_scene, run_teach
    from nclt_slam_tpu.scene import default_scene, get_route

    cfg = config_for("gt", args.scale)  # teach runs with GT relay (--use-gt)
    route = get_route(args.route)
    scene = pack_scene(default_scene())
    packed = pack_route(route, cfg)

    print(f"[teach] {args.route}: {route.n_dense} dense WPs, "
          f"{args.ticks} ticks max")
    res = jax.jit(lambda: run_teach(scene, packed, cfg, args.ticks,
                                    seed=args.seed))()
    n = int(res.n_ticks)
    print(f"[teach] ROUTE COMPLETE in {n} ticks, "
          f"{int(res.store.count)} landmarks")
    out = write_teach_artifacts(args.out, res, route, cfg)
    print(f"[teach] artefacts -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

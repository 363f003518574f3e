#!/usr/bin/env python3
"""Differential whole-tick profiling: time the real 15-route repeat scan
under config ablations and report deltas.  Unlike isolated-stage timing,
nothing can be loop-hoisted — each variant runs the genuine composed
program, so (variant - base) is the true cost of the ablated stage."""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", type=int, default=15)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    from nclt_slam_tpu.runtime import init_runtime

    init_runtime(args.platform)

    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.landmarks.store import init_store
    from nclt_slam_tpu.rollout.campaign import (
        build_campaign, run_campaign_teach, teach_waypoints)
    from nclt_slam_tpu.rollout.repeat import init_repeat_carry, run_repeat
    from nclt_slam_tpu.scene.routes import ALL_ROUTES

    base = cfg_mod.ours()
    names = ALL_ROUTES[: args.routes]
    data = build_campaign(names, cfg=base)
    teach_cfg = cfg_mod.gt_localization().replace(
        teach=dataclasses.replace(cfg_mod.DEFAULT.teach, run_vio=False))
    teach = run_campaign_teach(data, teach_cfg, 100)
    wps, n_wps = teach_waypoints(data, teach, base)
    R = len(names)

    def variant(cfg, label):
        stores = jax.vmap(lambda _: init_store(cfg.landmarks))(jnp.arange(R))
        carry = jax.vmap(
            lambda rt, wp, nw: init_repeat_carry(rt, wp, nw, cfg))(
            data.routes, wps, n_wps)
        f = jax.jit(jax.vmap(
            lambda sc, rt, tg, wp, nw, st, c: run_repeat(
                sc, rt, tg, wp, nw, cfg, args.ticks, store=st, carry=c),
            in_axes=(0, 0, 0, 0, 0, 0, 0)))
        out = f(data.scenes_repeat, data.routes, teach.teach_grid, wps,
                n_wps, stores, carry)
        jax.block_until_ready(out.trace.gt_xy)
        t0 = time.perf_counter()
        out = f(data.scenes_repeat, data.routes, teach.teach_grid, wps,
                n_wps, stores, carry)
        jax.block_until_ready(out.trace.gt_xy)
        dt = (time.perf_counter() - t0) / args.ticks * 1e3
        print(f"{label:42s} {dt:9.2f} ms/tick", flush=True)
        return dt

    P = lambda **kw: dataclasses.replace(base.planner, **kw)
    M = lambda **kw: dataclasses.replace(base.map, **kw)
    V = lambda **kw: dataclasses.replace(base.vio, **kw)
    L = lambda **kw: dataclasses.replace(base.landmarks, **kw)
    C = lambda **kw: dataclasses.replace(base.camera, **kw)

    t_base = variant(base, "ours (base)")
    variant(cfg_mod.gt_localization(), "gt mode")
    variant(base.replace(map=M(update_period=10 ** 6)),
            "ours - costmap update branch")
    variant(cfg_mod.gt_localization().replace(map=M(update_period=10 ** 6)),
            "gt - costmap update branch")
    variant(base.replace(vio=V(enable_local_ba=False)), "ours - local_ba")
    variant(base.replace(mode=dataclasses.replace(base.mode,
                                                  use_anchors=False)),
            "ours - anchors (matcher)")
    variant(base.replace(planner=P(sweeps=1)), "ours planner sweeps=1")
    variant(base.replace(camera=C(ray_steps=48)), "ours ray_steps=48")
    variant(base.replace(camera=C(ray_cols=40, ray_rows=30)),
            "ours ray grid 40x30")
    variant(base.replace(vio=V(gn_iters=4)), "ours gn_iters=4")
    variant(base.replace(landmarks=L(ransac_iterations=64)),
            "ours ransac_iters=64")


if __name__ == "__main__":
    main()

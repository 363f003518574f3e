#!/usr/bin/env python3
"""Per-stage timing of the ours-mode repeat tick on the device.

Times each pipeline stage as an isolated jitted scan (vmapped over the
route batch) so per-call costs are measured with dispatch amortized, then
prints a table with the per-tick amortized cost (stage cost / cadence
period).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, iters=50, name=""):
    out = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    dt = (time.perf_counter() - t0) / iters
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", type=int, default=15)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warm", type=int, default=0,
                    help="run the full repeat scan this many ticks first "
                         "and profile from the warm carry (full landmark "
                         "stores / VIO maps / live costmap)")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    from nclt_slam_tpu.runtime import init_runtime

    init_runtime(args.platform)

    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.landmarks.store import init_store
    from nclt_slam_tpu.rollout.campaign import build_campaign, run_campaign_teach, teach_waypoints
    from nclt_slam_tpu.rollout.repeat import (
        init_repeat_carry, repeat_step, GRAVITY)
    from nclt_slam_tpu.scene.routes import ALL_ROUTES

    cfg = cfg_mod.ours()
    names = ALL_ROUTES[: args.routes]
    data = build_campaign(names, cfg=cfg)
    R = len(names)

    # teach artefacts (short by default; --warm implies a real teach) so
    # store/map are realistic
    teach_ticks = 100 if args.warm == 0 else 2000
    teach = run_campaign_teach(data, cfg_mod.gt_localization(), teach_ticks)
    wps, n_wps = teach_waypoints(data, teach, cfg)
    if args.warm:
        stores = teach.store   # teach-recorded landmark stores, like bench
    else:
        stores = jax.vmap(lambda _: init_store(cfg.landmarks))(jnp.arange(R))

    carry = jax.vmap(lambda rt, wp, nw: init_repeat_carry(rt, wp, nw, cfg))(
        data.routes, wps, n_wps)
    scene = data.scenes_repeat
    route = data.routes
    teach_grid = teach.teach_grid

    if args.warm:
        # advance the full stack so stores/maps/grids are steady-state
        # (note: a compiled program's cost is data-independent — this mode
        # exists to measure stage costs over REPRESENTATIVE control flow,
        # e.g. committed fusion + live costmap windows, and to cross-check
        # bench's warm-window numbers).  Warm through the CHUNKED campaign
        # runner, the production path.
        from nclt_slam_tpu.rollout.campaign import run_campaign_repeat
        warm = run_campaign_repeat(data, teach_grid, wps, n_wps, cfg,
                                   args.warm, stores=stores, carry=carry,
                                   stop_when_done=False)
        carry = warm.final
        jax.block_until_ready(carry.robot.xy)

    N_TICKS = args.iters
    results = {}

    # ---- full tick ----
    # big arrays go through jit ARGUMENTS: closure-captured device arrays
    # would be baked into the program as ~100 MB of constants
    def full_scan(c, scene, route, teach_grid, stores):
        def body(c, t):
            return jax.vmap(
                lambda ci, sc, rt, tg, st: repeat_step(
                    ci, t, sc, rt, tg, st, cfg),
                in_axes=(0, 0, 0, 0, 0))(c, scene, route, teach_grid, stores)
        c, tr = jax.lax.scan(body, c, jnp.arange(N_TICKS))
        return tr.gt_xy

    results["full_tick"] = timed(jax.jit(full_scan), carry, scene, route,
                                 teach_grid, stores, iters=N_TICKS)

    # ---- stage: dynamics ----
    from nclt_slam_tpu.dynamics.diffdrive import nav_substeps

    def dyn_scan(c):
        def body(rc, t):
            robot, key = rc
            key, k = jax.random.split(key)
            ks = jax.random.split(k, R)
            robot, _ = jax.vmap(
                lambda rb, sc, kk: nav_substeps(
                    rb, jnp.float32(0.5), jnp.float32(0.1), sc.xy, sc.radius,
                    sc.valid, kk, cfg.sim))(robot, scene, ks)
            return (robot, key), robot.xy
        (_, _), xs = jax.lax.scan(body, (c.robot, jax.random.PRNGKey(0)),
                                  jnp.arange(N_TICKS))
        return xs

    results["dynamics(20 substeps)"] = timed(jax.jit(dyn_scan), carry,
                                             iters=N_TICKS)

    # ---- stage: IMU block ----
    from nclt_slam_tpu.sensors.imu import imu_block
    pos_traj = jnp.zeros((R, cfg.sim.nav_decimation, 3))
    quat_traj = jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0]),
                         (R, cfg.sim.nav_decimation, 1))

    def imu_scan(c):
        def body(st, t):
            st, meas = jax.vmap(
                lambda s, pt, qt: imu_block(s, pt, qt,
                                            1.0 / cfg.sim.physics_hz,
                                            jax.random.PRNGKey(0), cfg.imu))(
                st, pos_traj, quat_traj)
            return st, meas.sum()
        st, xs = jax.lax.scan(body, c.imu, jnp.arange(N_TICKS))
        return xs

    results["imu_block"] = timed(jax.jit(imu_scan), carry, iters=N_TICKS)

    # ---- stage: observe ----
    from nclt_slam_tpu.rollout.repeat import _scene_features
    from nclt_slam_tpu.sensors.features import observe
    pos3 = jnp.concatenate([route.spawn, jnp.ones((R, 1))], -1)
    yaw = route.spawn_yaw

    def obs_scan(_, scene, pos3, yaw):
        def body(acc, t):
            o = jax.vmap(
                lambda p, y, sc: observe(p, y, _scene_features(sc), sc.valid,
                                         jax.random.PRNGKey(0), cfg.camera,
                                         cfg.landmarks))(pos3, yaw, scene)
            return acc + o.uv.sum(), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(N_TICKS))
        return acc

    results["observe"] = timed(jax.jit(obs_scan), carry, scene, pos3, yaw,
                               iters=N_TICKS)

    # ---- stage: vio_frame ----
    from nclt_slam_tpu.vio.tracker import vio_frame, local_ba
    obs0 = jax.vmap(
        lambda p, y, sc: observe(p, y, _scene_features(sc), sc.valid,
                                 jax.random.PRNGKey(0), cfg.camera,
                                 cfg.landmarks))(pos3, yaw, scene)
    imu_meas0 = jnp.zeros((R, cfg.sim.nav_decimation, 6))

    def vio_scan(c, obs0, imu_meas0):
        def body(v, t):
            v, ok, _aux = jax.vmap(
                lambda vi, o, m: vio_frame(
                    vi, o, m, cfg.sim.nav_decimation / cfg.sim.physics_hz,
                    GRAVITY, cfg.camera, cfg.vio, True))(v, obs0, imu_meas0)
            return v, ok
        v, _ = jax.lax.scan(body, c.vio, jnp.arange(N_TICKS))
        return v.pos

    results["vio_frame"] = timed(jax.jit(vio_scan), carry, obs0, imu_meas0,
                                 iters=N_TICKS)

    # ---- sub-stage: cross_check_match only ----
    from nclt_slam_tpu.sensors.features import cross_check_match

    def ccm_scan(c, obs0):
        def body(acc, t):
            idx, m, d = jax.vmap(
                lambda o, v: cross_check_match(o.desc, o.valid, v.map_desc,
                                               v.map_valid, return_dist=True)
            )(obs0, c.vio)
            return acc + m.sum(), None
        acc, _ = jax.lax.scan(body, jnp.int32(0), jnp.arange(N_TICKS))
        return acc

    results["  cross_check_match"] = timed(jax.jit(ccm_scan), carry, obs0,
                                           iters=N_TICKS)

    # ---- stage: local_ba (per call; cadence 1/10) ----
    def ba_scan(c):
        def body(v, t):
            v = jax.vmap(lambda vi: local_ba(vi, cfg.camera, cfg.vio))(v)
            return v, None
        v, _ = jax.lax.scan(body, c.vio, jnp.arange(N_TICKS))
        return v.pos

    results["local_ba (per call)"] = timed(jax.jit(ba_scan), carry,
                                           iters=N_TICKS)

    # ---- stage: match_tick (per call; cadence 1/5) ----
    from nclt_slam_tpu.landmarks.matcher import match_tick

    def match_scan(c, stores, obs0, spawn, yaw):
        def body(acc, t):
            res = jax.vmap(
                lambda st, o, xy, y: match_tick(
                    st, o, xy, y, jnp.array([xy[0], xy[1], 0.0]),
                    jax.random.PRNGKey(0), cfg.camera, cfg.landmarks))(
                stores, obs0, spawn, yaw)
            return acc + res.xy.sum(), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(N_TICKS))
        return acc

    results["match_tick (per call)"] = timed(jax.jit(match_scan), carry,
                                             stores, obs0, route.spawn, yaw,
                                             iters=N_TICKS)

    # ---- stage: fusion_tick ----
    from nclt_slam_tpu.fusion.relay import fusion_tick

    def fuse_scan(c):
        def body(f, t):
            f, x, y2, yw, reg = jax.vmap(
                lambda fi, xy, y: fusion_tick(
                    fi, xy[0], xy[1], y, jnp.zeros(3),
                    jnp.array([0.0, 0.0, 0.0, 1.0]), jnp.array(True), t,
                    jax.random.PRNGKey(0), cfg.encoder, cfg.fusion))(
                f, route.spawn, yaw)
            return f, x
        f, _ = jax.lax.scan(body, c.fusion, jnp.arange(N_TICKS))
        return f.prev_nav

    results["fusion_tick"] = timed(jax.jit(fuse_scan), carry, iters=N_TICKS)

    # ---- costmap pieces (per call; cadence 1/5) ----
    from nclt_slam_tpu.sensors.depth import (
        render_depth, depth_to_cam_points, cam_points_to_world)
    from nclt_slam_tpu.mapping.occupancy import (
        integrate_depth, occupancy_trinary, crop_window, inflate_cost,
        world_to_cell)

    def depth_scan(_, scene, pos3, yaw):
        def body(acc, t):
            d, pw, dv = jax.vmap(
                lambda p, y, sc: render_depth(p, y, sc.xy, sc.radius,
                                              sc.base_z, sc.height, sc.valid,
                                              cfg.camera))(pos3, yaw, scene)
            return acc + d.sum(), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(N_TICKS))
        return acc

    results["render_depth (per call)"] = timed(jax.jit(depth_scan), carry,
                                               scene, pos3, yaw,
                                               iters=N_TICKS)

    depth0, _, dvalid0 = jax.vmap(
        lambda p, y, sc: render_depth(p, y, sc.xy, sc.radius, sc.base_z,
                                      sc.height, sc.valid, cfg.camera))(
        pos3, yaw, scene)

    def integrate_scan(c, depth0, dvalid0, spawn, yaw):
        def body(g, t):
            def one(gi, d, dv, xy, y):
                p_cam = depth_to_cam_points(d, cfg.camera)
                pts = cam_points_to_world(
                    p_cam, jnp.array([xy[0], xy[1], 1.0]), y, cfg.camera)
                return integrate_depth(gi, xy, pts.reshape(-1, 3),
                                       dv.reshape(-1), cfg.map)
            g = jax.vmap(one)(g, depth0, dvalid0, spawn, yaw)
            return g, None
        g, _ = jax.lax.scan(body, c.grid_live, jnp.arange(N_TICKS))
        return g

    results["integrate_depth (per call)"] = timed(jax.jit(integrate_scan),
                                                  carry, depth0, dvalid0,
                                                  route.spawn, yaw,
                                                  iters=N_TICKS)

    def inflate_scan(c, teach_grid, spawn):
        def body(acc, t):
            def one(g, tg, xy):
                tri = occupancy_trinary(g, cfg.map)
                comb = jnp.maximum(tri, tg)
                r, cc = world_to_cell(xy[0], xy[1], cfg.map)
                win, r0, c0 = crop_window(comb, r, cc, cfg.planner.window)
                return inflate_cost(win, cfg.map)
            cw = jax.vmap(one)(c.grid_live, teach_grid, spawn)
            return acc + cw.sum(), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(N_TICKS))
        return acc

    results["trinary+crop+inflate (per call)"] = timed(
        jax.jit(inflate_scan), carry, teach_grid, route.spawn,
        iters=N_TICKS)

    # ---- dispatch_plan (wavefront + projection etc; cadence 1/5) ----
    from nclt_slam_tpu.planning.dispatcher import dispatch_plan

    def plan_scan(c, scene, spawn):
        def body(d, t):
            d2 = jax.vmap(
                lambda di, xy, cw, sc: dispatch_plan(
                    di, xy, cw, jnp.int32(0), jnp.int32(0), sc.xy, sc.radius,
                    sc.drop_mask & sc.valid, cfg.map, cfg.planner))(
                d, spawn, c.cost_win, scene)
            return d2, None
        d, _ = jax.lax.scan(body, c.dispatch, jnp.arange(N_TICKS))
        return d.path_xy

    results["dispatch_plan (per call)"] = timed(jax.jit(plan_scan), carry,
                                                scene, route.spawn,
                                                iters=N_TICKS)

    # ---- follower + dispatch_move ----
    from nclt_slam_tpu.control.pure_pursuit import follower_tick
    from nclt_slam_tpu.planning.dispatcher import dispatch_move

    def ctrl_scan(c, scene, spawn, yaw):
        def body(cc, t):
            ctrl, disp = cc
            disp = jax.vmap(
                lambda di, xy, sc: dispatch_move(di, xy, sc.xy, sc.radius,
                                                 sc.drop_mask & sc.valid,
                                                 cfg.planner))(
                disp, spawn, scene)
            ctrl, v, w = jax.vmap(
                lambda ct, xy, y, di, cw, r0, c0: follower_tick(
                    ct, xy, y, di.path_xy, di.n_path,
                    di.has_path & ~di.done, di.plan_version, cw, r0, c0,
                    t.astype(jnp.float32) * 0.1, cfg.map, cfg.control,
                    cfg.planner.window))(
                ctrl, spawn, yaw, disp, c.cost_win, c.win_r0, c.win_c0)
            return (ctrl, disp), v
        (_, _), xs = jax.lax.scan(body, (c.ctrl, c.dispatch),
                                  jnp.arange(N_TICKS))
        return xs

    results["dispatch_move+follower"] = timed(jax.jit(ctrl_scan), carry,
                                              scene, route.spawn, yaw,
                                              iters=N_TICKS)

    # ---- report ----
    print(f"\n{'stage':36s} {'per-call ms':>12s} {'per-tick ms':>12s}")
    cadence = {"local_ba (per call)": 10,
               "match_tick (per call)": cfg.landmarks.tick_period,
               "render_depth (per call)": cfg.map.update_period,
               "integrate_depth (per call)": cfg.map.update_period,
               "trinary+crop+inflate (per call)": cfg.map.update_period,
               "dispatch_plan (per call)": cfg.map.update_period}
    total = 0.0
    for k, v in results.items():
        per_tick = v * 1e3 / cadence.get(k, 1)
        if k != "full_tick" and not k.startswith("  "):
            total += per_tick
        print(f"{k:36s} {v * 1e3:12.3f} {per_tick:12.3f}")
    print(f"{'sum of stages':36s} {'':12s} {total:12.3f}")
    print(f"(batch={R} routes, {N_TICKS} scan iters per timing)")


if __name__ == "__main__":
    main()

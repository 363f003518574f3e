#!/usr/bin/env python3
"""Benchmark: batched repeat-campaign throughput on one device.

Prints ONE JSON line:
  {"metric": "env_steps_per_sec_per_chip", "value": N, "unit": "steps/s",
   "vs_baseline": N}

Metric definition (BASELINE.json): env steps/sec/chip on the route batch,
where one env step = one 200 Hz physics substep of one route.  One nav tick
= 20 substeps, and the batch runs all routes simultaneously.

Baseline: the reference runs Isaac at 18-30 % of wall clock on an RTX 3090,
one route at a time (routes/README.md:125) — i.e. ~0.24 x 200 Hz = 48 env
steps/sec aggregate.  vs_baseline = ours / 48.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def _measure_mode(mode: str, names, n_ticks: int, teach_ticks: int,
                  warm_ticks: int):
    """Steady-state steps/s for one localization mode: run ``warm_ticks``
    untimed (teach-warmup + map/store fill transient — VERDICT r2 weak #5),
    then time an ``n_ticks`` window continuing from the warm carry."""
    import numpy as np

    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.cli.common import MODES
    from nclt_slam_tpu.rollout.campaign import (
        build_campaign,
        planned_chunks,
        run_campaign_repeat,
        run_campaign_teach,
        teach_waypoints,
    )

    cfg = MODES[mode]()
    cfg_teach = cfg_mod.gt_localization()
    data = build_campaign(names, cfg=cfg)

    # teach long enough that every route still has live waypoints through
    # the warm + timed repeat window (a 100-tick teach left ~3 WPs/route:
    # all routes finished by tick ~76, the campaign runner's done-break cut
    # every "500-tick" window to 250 executed ticks, and the r3 headline
    # credited the unexecuted half — ADVICE r3 #1)
    teach = run_campaign_teach(data, cfg_teach, teach_ticks)
    jax.block_until_ready(teach.teach_grid)
    wps, n_wps = teach_waypoints(data, teach, cfg)
    stores = None if mode == "gt" else teach.store

    # warm phase: compile + drive past the startup transient (alignment
    # window, VIO map fill, first anchors).  stop_when_done=False so the
    # final carry sits at a deterministic executed tick count.
    n_wc, wc = planned_chunks(warm_ticks, 250)
    warm_exec = n_wc * wc
    warm = run_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg,
                               warm_ticks, stores=stores,
                               stop_when_done=False)
    jax.block_until_ready(warm.final.robot.xy)

    # prime the EXACT timed-window program untimed: a different window
    # length picks a different chunk size (a fresh executable), and a
    # scan-output carry can retrace against the init-carry trace via weak
    # types — either way the first timed-window call used to eat a ~70 s
    # XLA compile, which is what round 3's 1,692 steps/s "steady state"
    # headline actually measured (the compiled program runs ~20x faster).
    n_tc, tc = planned_chunks(n_ticks, 250)
    exec_ticks = n_tc * tc   # what actually runs (done-break disabled)

    def timed_window():
        out = run_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg,
                                  n_ticks, stores=stores, carry=warm.final,
                                  tick0=warm_exec, stop_when_done=False)
        jax.block_until_ready(out.final.robot.xy)
        return out

    out = timed_window()
    # honesty guard: the timed window must measure routes doing real work,
    # not a finished campaign idling (compiled cost is data-independent,
    # but the recorded headline claims full-stack *navigation* throughput)
    done_last = np.asarray(out.trace.done)[:, -1]
    active_frac = float((~done_last).mean())

    # timed steady-state window: median of 3 identical re-runs from the
    # same warm carry (sustained throughput, compile excluded)
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        timed_window()
        dts.append(time.perf_counter() - t0)
    dt = sorted(dts)[1]

    substeps = cfg.sim.nav_decimation
    return exec_ticks * substeps * len(names) / dt, dt, exec_ticks, active_frac


def main():
    from nclt_slam_tpu.runtime import init_runtime

    init_runtime()
    n_routes = int(os.environ.get("BENCH_ROUTES", "15"))
    # 500 = 2 x the 250-tick chunk, so the timed window reuses the warm
    # phase's chunk executable (one compile for both)
    n_ticks = int(os.environ.get("BENCH_TICKS", "500"))
    # 1500 teach ticks ≈ 120 m of recorded route — enough waypoints that
    # every route is still actively navigating through warm+timed repeat
    # ticks (the honesty guard below records the live fraction)
    teach_ticks = int(os.environ.get("BENCH_TEACH_TICKS", "1500"))
    warm_ticks = int(os.environ.get("BENCH_WARM_TICKS", "2000"))
    # the recorded headline measures the FULL flagship stack (VIO + anchors
    # + v55 fusion); gt/encoder/rgbd modes remain selectable for comparison
    mode = os.environ.get("BENCH_MODE", "ours")  # ours | gt | encoder | rgbd

    from nclt_slam_tpu.scene.routes import ALL_ROUTES

    names = ALL_ROUTES[:n_routes]
    steps_per_sec, dt, exec_ticks, active_frac = _measure_mode(
        mode, names, n_ticks, teach_ticks, warm_ticks)

    # secondary metric: sliding-window BA solves/sec (batched windows)
    ba_rate = _bench_ba()

    extra = {"ba_solves_per_sec": round(ba_rate, 1),
             "routes": len(names), "ticks": exec_ticks,
             "warm_ticks": warm_ticks, "mode": mode,
             "wall_s": round(dt, 2),
             # fraction of routes still navigating at the window's end;
             # ~1.0 means the headline measured live full-stack work
             "active_route_frac": round(active_frac, 3),
             # active-route-only throughput (VERDICT r4 weak #7: report
             # both): steps attributable to routes still navigating
             "active_steps_per_sec": round(steps_per_sec * active_frac, 1)}
    # companion speed-of-light line: same window, gt localization — makes
    # the headline self-contained (full stack vs no-perception ceiling)
    if mode != "gt" and os.environ.get("BENCH_GT_LINE", "1") != "0":
        gt_rate, _, _, _ = _measure_mode("gt", names, n_ticks, teach_ticks,
                                         min(warm_ticks, 500))
        extra["gt_steps_per_sec"] = round(gt_rate, 1)
    if os.environ.get("BENCH_ROOFLINE", "1") != "0":
        extra["roofline"] = _roofline()

    baseline = 0.24 * 200.0  # reference: 18-30 % of real time, one route
    dev = jax.devices()[0]
    extra["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}
    print(json.dumps({
        "metric": "env_steps_per_sec_per_chip",
        "value": round(steps_per_sec, 1),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_sec / baseline, 2),
        "extra": extra,
    }))


def _ba_flops_per_iter(K: int, P: int) -> float:
    """Analytic FLOP count for one solve_ba GN iteration (fp32, +-20 %):
    residual + two jacfwd sweeps (~10 residual evals x ~150 FLOP each),
    Hessian-block einsums, the landmark Schur complement (dominant:
    pai,pij,pbj->ab is 216 K^2 P), landmark 3x3 inverses, and the dense
    (6K)^3 camera solve."""
    return (K * P * 1500.0          # residuals + jacobians
            + K * P * 420.0         # H_pp/H_ll/H_pl/g einsums
            + 216.0 * K * K * P + 108.0 * K * P   # Schur complement
            + 120.0 * P             # H_ll inverses
            + 144.0 * K ** 3)       # dense reduced solve


def _roofline():
    """Work counts beside the rates of the secondary solvers.

    BA: solves/s over a window-size sweep up to covisibility scale, with
    achieved TFLOP/s from the analytic count (no peak is assumed: the
    device's peak table belongs with the benchmark's device check).

    Raycaster: rays/s for the full 15-route sensing batch plus the analytic
    per-ray cost (34 terrain evals x ~70 FLOP + N_collider cylinder tests
    x ~30 FLOP), element-wise and transcendental work with no matmul.
    """
    out = {"ba_sweep": []}
    for K, P, batch in [(10, 48, 64), (10, 128, 64), (16, 256, 32),
                        (24, 512, 8)]:
        rate = _bench_ba(batch=batch, iters=8, K=K, P=P)
        fl = _ba_flops_per_iter(K, P) * 8
        out["ba_sweep"].append({
            "K": K, "P": P, "batch": batch,
            "solves_per_sec": round(rate, 1),
            "gflops_per_solve": round(fl / 1e9, 3),
            "achieved_tflops": round(rate * fl / 1e12, 3),
        })
    out["raycast"] = _bench_raycast()
    out["pgo"] = _bench_pgo()
    return out


def _bench_pgo(K: int = 2000, n_loops: int = 48, iters: int = 5):
    """km-scale 2-D PGO: the fused junction-reduced solver (production path,
    datasets/slam/pipeline.py) vs the dense jacfwd optimizer it replaced, at
    the NCLT ladder's 2000-pose shape, plus the host-reduced middle
    ground."""
    import numpy as np

    from nclt_slam_tpu.datasets.slam.loop_closure import (
        PoseGraph2D,
        optimize_pose_graph,
        optimize_pose_graph_fast,
        reduce_pose_graph,
    )

    rng = np.random.RandomState(11)
    th = np.linspace(0, 4 * np.pi, K)
    gt = np.stack([60 * np.cos(th), 60 * np.sin(th), th + np.pi / 2], -1)
    odo = np.diff(gt, axis=0).astype(np.float32)
    # convert world diffs to body frame + noise
    c, s = np.cos(gt[:-1, 2]), np.sin(gt[:-1, 2])
    odo = np.stack([c * odo[:, 0] + s * odo[:, 1],
                    -s * odo[:, 0] + c * odo[:, 1],
                    odo[:, 2]], -1).astype(np.float32)
    odo[:, :2] += rng.normal(0, 0.02, (K - 1, 2)) + 0.003
    poses = np.zeros((K, 3), np.float32)
    poses[0] = gt[0]
    for k in range(K - 1):
        cc, ss = np.cos(poses[k, 2]), np.sin(poses[k, 2])
        poses[k + 1] = (poses[k, 0] + cc * odo[k, 0] - ss * odo[k, 1],
                        poses[k, 1] + ss * odo[k, 0] + cc * odo[k, 1],
                        poses[k, 2] + odo[k, 2])
    li = np.linspace(10, K // 2 - 10, n_loops).astype(np.int32)
    lj = np.minimum(li + K // 2, K - 1).astype(np.int32)
    lm = np.zeros((n_loops, 3), np.float32)
    for e in range(n_loops):
        i, j = li[e], lj[e]
        cc, ss = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        d = gt[j, :2] - gt[i, :2]
        lm[e] = (cc * d[0] + ss * d[1], -ss * d[0] + cc * d[1],
                 gt[j, 2] - gt[i, 2])
    graph = PoseGraph2D(
        poses=jnp.asarray(poses), odo_meas=jnp.asarray(odo),
        loop_i=jnp.asarray(li), loop_j=jnp.asarray(lj),
        loop_meas=jnp.asarray(lm),
        loop_valid=jnp.ones(n_loops, bool))
    reduced, red_w, junctions = reduce_pose_graph(graph, 1.0)

    def t_of(fn, reps=3):
        fn()  # compile/prime
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps

    f_dense = jax.jit(lambda g: optimize_pose_graph(g, iters=iters))
    t_dense = t_of(lambda: jax.block_until_ready(f_dense(graph)), reps=1)
    f_red = jax.jit(lambda g, w: optimize_pose_graph(g, iters=iters,
                                                     odo_w=w))
    t_red = t_of(lambda: jax.block_until_ready(f_red(reduced, red_w)))
    # production path end-to-end: the fused single-program default
    # (on-device reduce -> reduced GN -> expand, loop_closure._pgo_fused)
    t_fast = t_of(lambda: jax.block_until_ready(
        optimize_pose_graph_fast(graph, iters=iters)))
    return {
        "K": K, "loops": n_loops, "iters": iters,
        "Kr": int(reduced.poses.shape[0]),
        "xla_dense_s": round(t_dense, 3),
        "xla_reduced_s": round(t_red, 4),
        "fast_end_to_end_s": round(t_fast, 4),
        "speedup_vs_dense": round(t_dense / max(t_fast, 1e-9), 1),
    }


def _bench_raycast(batch: int = 15, reps: int = 50):
    """Depth-raycaster throughput over a route-batch of poses."""
    import numpy as np

    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.rollout.campaign import build_campaign
    from nclt_slam_tpu.scene.terrain import terrain_height
    from nclt_slam_tpu.sensors.depth import render_depth

    cfg = cfg_mod.DEFAULT
    data = build_campaign(None, cfg=cfg)  # all routes (scene is cached)
    sc = data.scenes_repeat
    rng = np.random.RandomState(1)
    xy = rng.uniform(-60, 40, (batch, 2)).astype(np.float32)
    z = np.asarray(terrain_height(xy[:, 0], xy[:, 1])) + 0.31
    pos = jnp.asarray(np.column_stack([xy, z]))
    yaw = jnp.asarray(rng.uniform(-3, 3, batch).astype(np.float32))

    f = jax.jit(jax.vmap(
        lambda p, y, sxy, sr, sz, sh, sv: render_depth(
            p, y, sxy, sr, sz, sh, sv, cfg.camera)))
    args = (pos, yaw, sc.xy[:batch], sc.radius[:batch], sc.base_z[:batch],
            sc.height[:batch], sc.valid[:batch])
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    rays = batch * cfg.camera.ray_cols * cfg.camera.ray_rows
    n_coll = int(sc.xy.shape[1])
    flops_per_ray = 34 * 70.0 + n_coll * 30.0
    rays_per_sec = rays * reps / dt
    return {
        "rays_per_sec": round(rays_per_sec, 0),
        "frames_per_sec": round(batch * reps / dt, 1),
        "flops_per_ray_est": round(flops_per_ray, 0),
        "achieved_gflops": round(rays_per_sec * flops_per_ray / 1e9, 1),
    }


def _bench_ba(batch: int = 64, iters: int = 8, K: int | None = None,
              P: int | None = None):
    """Batched sliding-window BA throughput (default 10 KF x 128 pts),
    vmapped vio/ba.py:solve_ba."""
    import numpy as np

    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.vio.ba import BAProblem, solve_ba

    cfg = cfg_mod.DEFAULT
    rng = np.random.RandomState(0)
    K = K or cfg.vio.window_kf
    # P follows the rollout's local-BA problem size: the newest keyframe's
    # observed map slots (tracker.KF_OBS)
    if P is None:
        from nclt_slam_tpu.vio.tracker import KF_OBS
        P = KF_OBS

    def mk(seed):
        r = np.random.RandomState(seed)
        return BAProblem(
            kf_pos=jnp.asarray(np.cumsum(r.normal(0.5, 0.1, (K, 3)), 0),
                               jnp.float32),
            kf_quat=jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0]), (K, 1)),
            points=jnp.asarray(r.uniform(2, 14, (P, 3)), jnp.float32),
            obs_uv=jnp.asarray(r.uniform(0, 640, (K, P, 2)), jnp.float32),
            obs_z=jnp.asarray(r.uniform(1, 12, (K, P)), jnp.float32),
            obs_w=jnp.asarray(r.rand(K, P) < 0.4, jnp.float32),
            rel_dp=jnp.asarray(r.normal(0.5, 0.1, (K - 1, 3)), jnp.float32),
            rel_dq=jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0]), (K - 1, 1)),
            w_rel=jnp.float32(100.0))

    probs = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[mk(s) for s in range(batch)])
    f = jax.jit(jax.vmap(lambda p: solve_ba(
        p, cfg.camera, cfg.vio, iters=iters)))
    out = f(probs)
    jax.block_until_ready(out.kf_pos)
    t0 = time.perf_counter()
    out = f(probs)
    jax.block_until_ready(out.kf_pos)
    return batch / (time.perf_counter() - t0)


if __name__ == "__main__":
    sys.exit(main())

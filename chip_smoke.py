#!/usr/bin/env python3
"""Bring-up check: the 15-route teach-and-repeat campaign on NVIDIA GPUs.

    python chip_smoke.py               # one card: device, kernel parity, campaign
    python chip_smoke.py --four-cards  # only the route-sharded repeat on four cards

Phases, in order (one card):

1. device: a GPU or exit nonzero (no CPU fallback); the card's name and
   power limit, the JAX version, XLA_FLAGS, the compile-cache directory;
   matmul precision must be "highest" (true f32, not TF32).
2. kernel parity at real widths, each check printing its max error and the
   tolerance it is held to:
   - the CUDA wavefront relaxation against the XLA ``fori_loop`` reference
     (W=192, 384 sweeps, 15 windows): bit-exact on reachable cells;
   - ``cross_check_match`` on the card against a numpy popcount brute force
     at the matcher's and the tracker's shapes: exact;
   - ``solve_ba`` vmapped over 64 windows of 10 keyframes x 128 points on
     the card against the same call on the CPU.
3. the main path at the default config widths: build_campaign ->
   run_campaign_teach (gt, 1500 ticks) -> teach_waypoints ->
   run_campaign_repeat (ours, teach stores, 500 ticks) -> campaign_metrics,
   with checks on the traces and the table.

Every failed check exits nonzero before the result line.  The last line of
standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

WAVEFRONT_WINDOWS = 15       # one window per route
TEACH_TICKS = 1500           # as bench.py: every route still has live WPs
REPEAT_TICKS = 500           # two 250-tick chunks
FOUR_CARD_TICKS = 250        # one chunk: the comparison covers it
SHARD_GT_ATOL_M = 1e-4       # sharded vs one-card gt_xy, as the CPU dry run


def log(msg: str) -> None:
    print(f"[smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require_gpu(n: int = 1):
    """The JAX devices, or exit nonzero unless there are ``n`` GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        fail(f"needs {n} NVIDIA GPU(s); JAX found {len(devs)} "
             f"{devs[0].platform} device(s)")
    return devs


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip()


def phase_device(n_cards: int):
    import jax

    from nclt_slam_tpu.runtime import init_runtime

    cache = init_runtime()
    devs = require_gpu(n_cards)
    for line in nvidia_smi().splitlines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}; devices {[d.device_kind for d in devs]}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    prec = jax.config.jax_default_matmul_precision
    if prec != "highest":
        fail(f"jax_default_matmul_precision is {prec!r}, not 'highest'")
    log("matmul precision: highest (true f32)")
    return devs


# ---------------------------------------------------------------------------
# phase 2: kernel parity at real widths
# ---------------------------------------------------------------------------


def wavefront_windows(n: int, W: int, seed: int = 0):
    """(n, W, W) traversal costs with lethal walls (gaps left open) and a
    goal per window, like tests/test_ops.py but at full size."""
    from nclt_slam_tpu.planning.wavefront import BIG

    rng = np.random.RandomState(seed)
    big = np.float32(BIG)
    tc = rng.uniform(0.1, 0.2, (n, W, W)).astype(np.float32)
    phi0 = np.full((n, W, W), big, np.float32)
    for i in range(n):
        for _ in range(8):
            r, c = rng.randint(0, W - 4, 2)
            length = rng.randint(W // 8, W // 2)
            if rng.rand() < 0.5:
                tc[i, r:r + 3, c:c + length] = big
            else:
                tc[i, r:r + length, c:c + 3] = big
        while True:
            g = rng.randint(0, W, 2)
            if tc[i, g[0], g[1]] < big:
                phi0[i, g[0], g[1]] = 0.0
                break
    return tc, phi0


def _median_time(fn, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def check_wavefront():
    import jax
    import jax.numpy as jnp

    from nclt_slam_tpu.config import DEFAULT
    from nclt_slam_tpu.planning.wavefront import BIG, relax, relax_xla

    W = DEFAULT.planner.window
    n_iter = DEFAULT.planner.sweeps * W
    tc, phi0 = wavefront_windows(WAVEFRONT_WINDOWS, W)
    tc, phi0 = jnp.asarray(tc), jnp.asarray(phi0)
    kernel = jax.jit(jax.vmap(lambda t, p: relax(t, p, n_iter)))
    ref = jax.jit(jax.vmap(lambda t, p: relax_xla(t, p, n_iter)))
    out = np.asarray(kernel(tc, phi0))
    want = np.asarray(ref(tc, phi0))
    reach = want < BIG / 2
    err = float(np.abs(out[reach] - want[reach]).max())
    n_diff = int((out[reach] != want[reach]).sum())
    unreach_ok = bool((out[~reach] >= BIG / 2).all())
    log(f"wavefront {WAVEFRONT_WINDOWS}x{W}x{W}, {n_iter} sweeps: "
        f"reachable {int(reach.sum())} cells, max |err| {err:.3g}, "
        f"{n_diff} differing (tolerance: bit-exact); unreachable agree: "
        f"{unreach_ok}")
    if n_diff or not unreach_ok or reach.sum() < reach.size // 2:
        fail("wavefront kernel differs from the XLA reference")
    t_k = _median_time(lambda: kernel(tc, phi0))
    t_x = _median_time(lambda: ref(tc, phi0))
    log(f"wavefront time per batch of {WAVEFRONT_WINDOWS} plans (info): "
        f"kernel {t_k * 1e3:.3f} ms, XLA loop {t_x * 1e3:.3f} ms")


def random_descriptors(rng, n, words, share_from=None):
    d = rng.randint(0, 2 ** 32, (n, words), dtype=np.uint64).astype(np.uint32)
    if share_from is not None:
        k = min(n, len(share_from)) // 2
        d[:k] = share_from[rng.permutation(len(share_from))[:k]]
    return d


def check_matcher():
    import jax
    import jax.numpy as jnp

    from nclt_slam_tpu.config import DEFAULT
    from nclt_slam_tpu.sensors.features import (
        cross_check_match,
        cross_check_match_reference,
    )
    from nclt_slam_tpu.vio.tracker import MAP_CAP

    lm = DEFAULT.landmarks
    F, Wd, C = lm.max_obs_features, lm.desc_words, lm.max_candidates
    rng = np.random.RandomState(1)
    live = random_descriptors(rng, F, Wd)
    live_v = rng.rand(F) > 0.2
    # landmarks/matcher.py: teach view (F, W) vs live frame (F, W), vmapped
    # over the candidate views
    teach = np.stack([random_descriptors(rng, lm.feats_per_landmark, Wd,
                                         share_from=live) for _ in range(C)])
    teach_v = rng.rand(C, lm.feats_per_landmark) > 0.2
    f_match = jax.jit(jax.vmap(
        lambda d, v: cross_check_match(d, v, jnp.asarray(live),
                                       jnp.asarray(live_v),
                                       return_dist=True)))
    got = [np.asarray(x) for x in f_match(jnp.asarray(teach),
                                          jnp.asarray(teach_v))]
    n_bad = 0
    for c in range(C):
        want = cross_check_match_reference(teach[c], teach_v[c], live, live_v)
        n_bad += sum(int((g[c] != w).sum()) for g, w in zip(got, want))
    # vio/tracker.py: live frame (F, W) vs the VIO map (MAP_CAP, W)
    vmap_d = random_descriptors(rng, MAP_CAP, Wd, share_from=live)
    vmap_v = rng.rand(MAP_CAP) > 0.3
    got_t = [np.asarray(x) for x in jax.jit(
        lambda a, va, b, vb: cross_check_match(a, va, b, vb,
                                               return_dist=True))(
        live, live_v, vmap_d, vmap_v)]
    want_t = cross_check_match_reference(live, live_v, vmap_d, vmap_v)
    n_bad += sum(int((g != w).sum()) for g, w in zip(got_t, want_t))
    n_matched = int(got[1].sum() + got_t[1].sum())
    log(f"matcher ({C}x[{lm.feats_per_landmark}x{F}] + [{F}x{MAP_CAP}], "
        f"{Wd} words): {n_bad} differing outputs, {n_matched} matches "
        f"(tolerance: exact)")
    if n_bad or n_matched == 0:
        fail("cross_check_match differs from the numpy brute force")
    t = _median_time(lambda: f_match(jnp.asarray(teach),
                                     jnp.asarray(teach_v)), reps=20)
    log(f"matcher time, {C} candidate views (info): {t * 1e3:.3f} ms")


def ba_windows(batch: int, K: int, P: int, seed: int = 0):
    """Consistent BA windows: observations are projections of true points
    with pixel and depth noise (the tests/test_ba.py harness, vectorized)."""
    import jax
    import jax.numpy as jnp

    from nclt_slam_tpu.config import DEFAULT
    from nclt_slam_tpu.core.quat import quat_conj, quat_from_yaw, quat_mul, so3_exp
    from nclt_slam_tpu.vio.ba import BAProblem, _project_point

    cam = DEFAULT.camera
    rng = np.random.RandomState(seed)
    s = np.linspace(0, 1, K)
    gt_pos = np.stack([5 * s[None].repeat(batch, 0),
                       0.2 * np.sin(2 * s)[None] + rng.normal(0, 0.1, (batch, 1)),
                       np.full((batch, K), 0.5)], -1)
    gt_yaw = 0.4 * s[None] + rng.uniform(-0.3, 0.3, (batch, 1))
    pts = np.stack([rng.uniform(3, 14, (batch, P)),
                    rng.uniform(-6, 6, (batch, P)),
                    rng.uniform(0.2, 2.5, (batch, P))], -1)
    gt_quat = np.asarray(quat_from_yaw(jnp.asarray(gt_yaw)))
    proj = jax.vmap(jax.vmap(jax.vmap(
        lambda p, q, X: _project_point(p, q, X, cam),
        in_axes=(None, None, 0)), in_axes=(0, 0, None)))
    uv, z = (np.asarray(a) for a in proj(jnp.asarray(gt_pos),
                                         jnp.asarray(gt_quat),
                                         jnp.asarray(pts)))
    vis = (uv[..., 0] > 0) & (uv[..., 0] < cam.width) & (uv[..., 1] > 0) & \
        (uv[..., 1] < cam.height) & (z > 0.5) & (z < 15)
    obs_uv = np.where(vis[..., None], uv + rng.normal(0, 0.5, uv.shape), 0)
    obs_z = np.where(vis, z * (1 + rng.normal(0, 0.01, z.shape)), 0)
    q = jnp.asarray(gt_quat)
    rel_dq = np.asarray(jax.vmap(jax.vmap(quat_mul))(
        quat_conj(q[:, :-1]), q[:, 1:]))
    yaw0 = gt_yaw[:, :-1]
    d = gt_pos[:, 1:] - gt_pos[:, :-1]
    rel_dp = np.stack([np.cos(yaw0) * d[..., 0] + np.sin(yaw0) * d[..., 1],
                       -np.sin(yaw0) * d[..., 0] + np.cos(yaw0) * d[..., 1],
                       d[..., 2]], -1)
    pos0 = gt_pos + rng.normal(0, 0.15, gt_pos.shape)
    pos0[:, 0] = gt_pos[:, 0]
    quat0 = np.array(jax.vmap(jax.vmap(lambda a, b: quat_mul(a, so3_exp(b))))(
        q, jnp.asarray(rng.normal(0, 0.03, (batch, K, 3)))))
    quat0[:, 0] = gt_quat[:, 0]
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    return BAProblem(
        kf_pos=f32(pos0), kf_quat=f32(quat0),
        points=f32(pts + rng.normal(0, 0.2, pts.shape)),
        obs_uv=f32(obs_uv), obs_z=f32(obs_z), obs_w=f32(vis),
        rel_dp=f32(rel_dp), rel_dq=f32(rel_dq),
        w_rel=jnp.full((batch,), 100.0, jnp.float32))


# GPU vs CPU: the same f32 program with matmul precision "highest" on both,
# so the only difference is the order of reductions (einsum sums, the
# Cholesky); on consistent windows that stays at the level of f32 rounding
# amplified by the window's conditioning over 8 Gauss-Newton iterations.
BA_TOL = {"kf_pos": 1e-3, "kf_quat": 1e-4, "points": 1e-2}
BA_COST_RTOL = 1e-2


def check_ba():
    import jax

    from nclt_slam_tpu.config import DEFAULT
    from nclt_slam_tpu.vio.ba import solve_ba

    K, P, batch, iters = 10, 128, 64, 8     # the bench's BA cell
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        probs = ba_windows(batch, K, P)
    f = jax.jit(jax.vmap(lambda p: solve_ba(p, DEFAULT.camera, DEFAULT.vio,
                                            iters=iters)))
    gpu_out = f(jax.device_put(probs, jax.devices()[0]))
    cpu_out = f(jax.device_put(probs, cpu))
    errs = {k: float(np.abs(np.asarray(getattr(gpu_out, k))
                            - np.asarray(getattr(cpu_out, k))).max())
            for k in BA_TOL}
    gc, cc = np.asarray(gpu_out.final_cost), np.asarray(cpu_out.final_cost)
    cost_rel = float((np.abs(gc - cc) / np.maximum(np.abs(cc), 1e-6)).max())
    finite = all(np.isfinite(np.asarray(getattr(gpu_out, k))).all()
                 for k in BA_TOL)
    log(f"BA {batch}x(K={K}, P={P}), {iters} iters, GPU vs CPU: " + ", ".join(
        f"{k} max|err| {errs[k]:.3g} (tol {BA_TOL[k]:g})" for k in BA_TOL)
        + f", cost rel {cost_rel:.3g} (tol {BA_COST_RTOL:g})")
    if not finite or cost_rel > BA_COST_RTOL or any(
            errs[k] > BA_TOL[k] for k in BA_TOL):
        fail("solve_ba on the GPU disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def _chunk_timer(tag: str, marks: list):
    def progress(done_ticks, total, n_done):
        marks.append(time.perf_counter())
        log(f"{tag} {done_ticks}/{total} ticks, {n_done} routes done")
    return progress


def _trace_finite(trace) -> list:
    import jax

    bad = []
    for path, x in jax.tree_util.tree_leaves_with_path(trace):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating) and not np.isfinite(x).all():
            bad.append(jax.tree_util.keystr(path))
    return bad


def teach_campaign(names):
    """Build + gt teach + waypoints, timed; returns the repeat inputs."""
    import jax

    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.rollout.campaign import (
        build_campaign,
        run_campaign_teach,
        teach_waypoints,
    )

    cfg = cfg_mod.ours()
    cfg_teach = cfg_mod.gt_localization()
    t0 = time.perf_counter()
    data = build_campaign(names, cfg=cfg)
    jax.block_until_ready(data.routes.spawn)
    log(f"set-up: build_campaign({len(names)} routes) "
        f"{time.perf_counter() - t0:.1f} s")
    marks = [time.perf_counter()]
    teach = run_campaign_teach(data, cfg_teach, TEACH_TICKS,
                               progress=_chunk_timer("teach", marks))
    wps, n_wps = teach_waypoints(data, teach, cfg)
    log(f"teach (gt, {TEACH_TICKS} ticks): {marks[-1] - marks[0]:.1f} s "
        f"(first chunk incl. compile {marks[1] - marks[0]:.1f} s)")
    bad = _trace_finite(teach.trace)
    if bad:
        fail(f"teach trace not finite: {bad}")
    return cfg, data, teach, wps, n_wps


def phase_campaign():
    import jax

    from nclt_slam_tpu.rollout.campaign import (
        campaign_metrics,
        planned_chunks,
        repeat_chunk_program,
        run_campaign_repeat,
    )
    from nclt_slam_tpu.scene.routes import ALL_ROUTES

    cfg, data, teach, wps, n_wps = teach_campaign(ALL_ROUTES)
    marks = [time.perf_counter()]
    rep = run_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg,
                              REPEAT_TICKS, stores=teach.store,
                              stop_when_done=False,
                              progress=_chunk_timer("repeat", marks))
    jax.block_until_ready(rep.final.robot.xy)
    steady = np.diff(marks[1:])
    log(f"repeat (ours, {REPEAT_TICKS} ticks, {len(ALL_ROUTES)} routes): "
        f"first chunk incl. compile {marks[1] - marks[0]:.1f} s, later "
        f"chunks {', '.join(f'{s:.2f}' for s in steady)} s (info)")
    per_route, agg = campaign_metrics(data, rep, wps, n_wps, cfg)

    chunk = planned_chunks(REPEAT_TICKS, 250)[1]
    args = (data.scenes_repeat, data.routes, teach.teach_grid, wps, n_wps,
            teach.store, rep.final, np.int32(0))
    mem = repeat_chunk_program(cfg, chunk).lower(*args).compile() \
        .memory_analysis()
    log(f"repeat chunk program memory_analysis (info): {mem}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"device peak_bytes_in_use (info): {stats.get('peak_bytes_in_use')}")

    tr = rep.trace
    bad = _trace_finite(tr)
    if bad:
        fail(f"repeat trace not finite: {bad}")
    wp = np.asarray(tr.wp_idx)
    path = np.hypot(*np.diff(np.asarray(tr.gt_xy), axis=1).transpose(2, 0, 1)
                    ).sum(1)
    log(f"wp_idx final per route: {wp[:, -1].tolist()}")
    log(f"path driven per route [m]: {np.round(path, 1).tolist()}")
    if not (wp[:, -1] > wp[:, 0]).all():
        fail(f"routes whose waypoint index did not advance: "
             f"{[n for n, w in zip(data.names, wp) if w[-1] <= w[0]]}")
    n_anchor = int(np.asarray(tr.anchor_ok).sum())
    log(f"anchors published across the batch: {n_anchor}")
    if n_anchor == 0:
        fail("anchor_ok never fired")
    if len(per_route) != len(ALL_ROUTES) or agg.get("routes") != len(ALL_ROUTES):
        fail("metrics table incomplete")
    log(f"metrics: {json.dumps(agg, default=float)}")


# ---------------------------------------------------------------------------
# phase 4 (--four-cards): the route-sharded campaign against one card
# ---------------------------------------------------------------------------


def _first_over(diff, tol):
    """Per route: the first tick whose |difference| exceeds ``tol``, or
    None."""
    out = []
    for row in diff:
        idx = np.nonzero(row > tol)[0]
        out.append(int(idx[0]) if len(idx) else None)
    return out


def phase_four_cards():
    import jax

    from nclt_slam_tpu.parallel import route_mesh, sharded_campaign_repeat
    from nclt_slam_tpu.rollout.campaign import (
        campaign_metrics,
        run_campaign_repeat,
    )
    from nclt_slam_tpu.scene.routes import ALL_ROUTES

    cfg, data, teach, wps, n_wps = teach_campaign(ALL_ROUTES)
    n = len(ALL_ROUTES)
    mesh = route_mesh(4)

    def run(sharded: bool):
        t0 = time.perf_counter()
        if sharded:
            out = sharded_campaign_repeat(
                data, teach.teach_grid, wps, n_wps, cfg, FOUR_CARD_TICKS,
                stores=teach.store, mesh=mesh, stop_when_done=False)
        else:
            out = run_campaign_repeat(
                data, teach.teach_grid, wps, n_wps, cfg, FOUR_CARD_TICKS,
                stores=teach.store, stop_when_done=False)
        jax.block_until_ready(out.final.robot.xy)
        return out, time.perf_counter() - t0

    # each program twice from the same inputs: the second call is the
    # steady time, and the pair shows whether one program repeats itself
    one, t_one = run(False)
    one_b, t_one_b = run(False)
    four, t_four = run(True)
    four_b, t_four_b = run(True)
    log(f"{FOUR_CARD_TICKS} ticks, {n} routes: one card {t_one:.1f} s "
        f"(incl. compile) then {t_one_b:.2f} s; four cards {t_four:.1f} s "
        f"(incl. compile) then {t_four_b:.2f} s (info)")
    devs = four.final.robot.xy.sharding.device_set
    padded = -(-n // 4) * 4                            # 15 routes -> 16
    if four.trace.gt_xy.shape[0] != padded or len(devs) != 4:
        fail(f"sharded batch: {four.trace.gt_xy.shape[0]} routes on "
             f"{len(devs)} devices, not {padded} on 4")

    g1 = np.asarray(one.trace.gt_xy)
    rerun1 = float(np.abs(np.asarray(one_b.trace.gt_xy) - g1).max())
    rerun4 = float(np.abs(np.asarray(four_b.trace.gt_xy)
                          - np.asarray(four.trace.gt_xy)).max())
    log(f"same program run twice, max |d gt_xy| [m]: one card {rerun1:.3g}, "
        f"four cards {rerun4:.3g}")
    g4 = np.asarray(four.trace.gt_xy)[:n]
    diff = np.abs(g4 - g1).max(-1)                     # (routes, ticks)
    log(f"per-route max |gt_xy four cards - one card| [m]: "
        f"{[float(f'{w:.3g}') for w in diff.max(1)]} "
        f"(tol {SHARD_GT_ATOL_M:g})")
    log(f"per-route first tick with any difference: {_first_over(diff, 0)}")
    first = _first_over(diff, SHARD_GT_ATOL_M)
    log(f"per-route first tick over tolerance: {first}")

    trimmed = jax.tree_util.tree_map(lambda x: np.asarray(x)[:n], four)
    per4, _ = campaign_metrics(data, trimmed, wps, n_wps, cfg)
    per1, _ = campaign_metrics(data, one, wps, n_wps, cfg)
    keys = ("cov_visited", "reached_final", "drift_n", "gt_samples")
    metric_diff = {name: [k for k in keys if per4[name][k] != per1[name][k]]
                   for name in data.names}
    metric_diff = {k: v for k, v in metric_diff.items() if v}
    log(f"per-route metrics that differ: {metric_diff or 'none'}")
    anchors = (int(np.asarray(one.trace.anchor_ok).sum()),
               int(np.asarray(four.trace.anchor_ok)[:n].sum()))
    log(f"anchors published (one card, four cards): {anchors}")
    if anchors[1] == 0:
        fail("no anchor published in the sharded run (stores missing?)")
    diverged = {name: t for name, t in zip(data.names, first) if t is not None}
    if diverged:
        cause = ("the one-card program does not repeat itself"
                 if rerun1 > 0 else
                 "the two programs round differently")
        fail(f"sharded run diverged ({cause}); first tick over tolerance "
             f"per route: {diverged}")
    if metric_diff:
        fail(f"per-route metrics differ: {metric_diff}")
    log(f"sharded run equals the one-card run on all {n} routes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the route-sharded repeat on four cards "
                         "and its one-card comparison")
    args = ap.parse_args(argv)

    n_cards = 4 if args.four_cards else 1
    devs = phase_device(n_cards)
    if args.four_cards:
        phase_four_cards()
    else:
        check_wavefront()
        check_matcher()
        check_ba()
        phase_campaign()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

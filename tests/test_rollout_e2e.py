"""End-to-end slice: teach -> artefacts -> repeat with GT localization.

Uses a miniature scene + route + decimated sensors so the whole loop runs
in seconds on the CPU mesh; the full-scale campaign runs on the GPU
(chip_smoke.py, bench.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nclt_slam_tpu import config as cfg_mod
from nclt_slam_tpu.config import CameraConfig, MapConfig, PlannerConfig
from nclt_slam_tpu.planning.dispatcher import subsample_waypoints
from nclt_slam_tpu.rollout import (
    PackedRoute,
    PackedScene,
    run_repeat,
    run_teach,
)
from nclt_slam_tpu.scene.routes import DENSE_CAP, Route
from nclt_slam_tpu.scene.terrain import terrain_height
from nclt_slam_tpu.sensors.features import build_scene_features

pytestmark = pytest.mark.slow


def small_config():
    base = cfg_mod.gt_localization()
    return base.replace(
        camera=dataclasses.replace(
            base.camera, ray_cols=16, ray_rows=12, ray_steps=48),
        map=dataclasses.replace(
            base.map, resolution=0.2, width_m=120.0, height_m=40.0,
            origin_x=-20.0, origin_y=-20.0),
        planner=dataclasses.replace(
            base.planner, window=64, path_len=96, max_waypoints=32,
            goal_timeout_ticks=200),
        # teach-time VIO + drift gate has its own tests (test_teach_drift);
        # keep the shared fixture lean
        teach=dataclasses.replace(base.teach, run_vio=False),
    )


def straight_route(length=40.0, ds=0.8):
    """Straight out-and-back test route along +x from origin."""
    n_out = int(length / ds) + 1
    xs = np.linspace(0.0, length, n_out)
    out = np.stack([xs, np.zeros_like(xs)], -1)
    back = out[::-1][1:]
    full = np.concatenate([out, back], 0).astype(np.float32)
    n = len(full)
    dense = np.zeros((DENSE_CAP, 2), np.float32)
    dense[:n] = full
    dense[n:] = full[-1]
    return Route(name="test_straight", dense_xy=dense, n_dense=n,
                 spawn=(0.0, 0.0), spawn_yaw=0.0,
                 turnaround=(length, 0.0), turnaround_idx=n_out - 1)


def tiny_scene(drop_on_path=True):
    """16 collider slots: flanking trees + optionally one drop barrel ON
    the path at x=20 (the repeat pass must detour or push past it)."""
    N = 16
    xy = np.zeros((N, 2), np.float32)
    radius = np.zeros(N, np.float32)
    height = np.zeros(N, np.float32)
    valid = np.zeros(N, bool)
    drop_mask = np.zeros(N, bool)
    # trees flanking the whole route (dense enough for the landmark
    # recorder's min-feature gate and for VIO coverage past the turnaround)
    flank = [(10, 4), (14, -4.5), (25, 4.5), (30, -4), (5, -3.5), (18, 3.8),
             (22, -3.6), (34, 4.2), (38, -3.8), (41, 3.5), (2, 3.6), (7, 4.4)]
    for i, (x, y) in enumerate(flank):
        xy[i] = (x, y)
        radius[i] = 0.7
        height[i] = 8.0
        valid[i] = True
    if drop_on_path:
        xy[8] = (20.0, 0.3)
        radius[8] = 0.4
        height[8] = 1.0
        valid[8] = True
        drop_mask[8] = True
    base_z = np.asarray(terrain_height(xy[:, 0], xy[:, 1]))
    feats = build_scene_features(xy, radius, base_z, height, valid,
                                 cfg_mod.DEFAULT.landmarks)
    return PackedScene(
        xy=jnp.asarray(xy), radius=jnp.asarray(radius),
        base_z=jnp.asarray(base_z), height=jnp.asarray(height),
        valid=jnp.asarray(valid), drop_mask=jnp.asarray(drop_mask),
        feat_xyz=feats.xyz, feat_desc=feats.desc,
        feat_owner=feats.owner, feat_valid=feats.valid,
        feat_pkeep=feats.pkeep, feat_view_thr=feats.view_thr,
        feat_view_alpha=feats.view_alpha)


def pack_test_route(route, cfg):
    wps, n_wps = subsample_waypoints(route.dense_xy, route.n_dense, cfg.planner)
    return PackedRoute(
        dense_xy=jnp.asarray(route.dense_xy),
        n_dense=jnp.int32(route.n_dense),
        spawn=jnp.asarray(route.spawn, jnp.float32),
        spawn_yaw=jnp.float32(route.spawn_yaw),
        turnaround=jnp.asarray(route.turnaround, jnp.float32),
        wps=jnp.asarray(wps), n_wps=jnp.int32(n_wps)), wps, n_wps


@pytest.fixture(scope="module")
def teach_result():
    cfg = small_config()
    route = straight_route()
    scene = tiny_scene(drop_on_path=False)   # teach runs without drops
    packed, _, _ = pack_test_route(route, cfg)
    run = jax.jit(lambda: run_teach(scene, packed, cfg, n_ticks=1400))
    return run(), cfg, route


def test_teach_completes_route(teach_result):
    res, cfg, route = teach_result
    assert int(res.n_ticks) < 1400          # finished before the cap
    xy = np.asarray(res.trace.gt_xy)
    done = np.asarray(res.trace.done)
    live = xy[~done]
    # robot went out to the turnaround and came back
    assert live[:, 0].max() > 36.0
    assert abs(live[-1, 0]) < 5.0
    # stays near the path
    assert np.abs(live[:, 1]).max() < 3.0


def test_teach_map_marks_trees(teach_result):
    res, cfg, route = teach_result
    grid = np.asarray(res.teach_grid)
    assert (grid == 2).sum() > 5            # some occupied cells
    # tree at (10, 4): cell should be occupied or near-occupied
    r = int((4.0 - cfg.map.origin_y) / cfg.map.resolution)
    c = int((10.0 - cfg.map.origin_x) / cfg.map.resolution)
    patch = grid[r - 3:r + 4, c - 3:c + 4]
    assert (patch == 2).any()
    # free space along the driven path
    r0 = int((0.0 - cfg.map.origin_y) / cfg.map.resolution)
    c0 = int((5.0 - cfg.map.origin_x) / cfg.map.resolution)
    assert (grid[r0 - 2:r0 + 3, c0 - 2:c0 + 3] == 0).any()


def test_repeat_with_gt_localization(teach_result):
    res, cfg, route = teach_result
    scene = tiny_scene(drop_on_path=True)    # drop appears in repeat
    packed, wps, n_wps = pack_test_route(route, cfg)
    run = jax.jit(lambda: run_repeat(
        scene, packed, res.teach_grid, wps, n_wps, cfg, n_ticks=2500))
    rep = run()
    xy = np.asarray(rep.trace.gt_xy)
    # made it out past the drop obstacle toward the turnaround
    assert xy[:, 0].max() > 36.0, f"max x = {xy[:, 0].max()}"
    # supervisor fired on the way back
    assert bool(rep.final.sup.fired)
    # got most WPs
    reached = int(rep.final.dispatch.reached_count)
    assert reached >= int(n_wps) * 0.6, f"reached {reached}/{n_wps}"
    # came back near spawn
    d_return = np.hypot(*(xy[-1] - np.asarray(route.spawn)))
    assert d_return < 12.0, f"return dist {d_return}"


def test_repeat_full_stack_localization(teach_result):
    """The flagship config: VIO + anchors + v55 fusion localization."""
    res, cfg_gt, route = teach_result
    cfg = cfg_mod.ours().replace(
        camera=cfg_gt.camera, map=cfg_gt.map, planner=cfg_gt.planner)
    scene = tiny_scene(drop_on_path=True)
    packed, wps, n_wps = pack_test_route(route, cfg)
    run = jax.jit(lambda: run_repeat(
        scene, packed, res.teach_grid, wps, n_wps, cfg, n_ticks=2500,
        store=res.store))
    rep = run()
    xy = np.asarray(rep.trace.gt_xy)
    nav = np.asarray(rep.trace.nav_xy)
    # localization drift stays bounded (the whole point of the stack)
    drift = np.hypot(*(nav - xy).T)
    assert np.isfinite(drift).all()
    assert drift[50:].mean() < 3.0, f"mean drift {drift[50:].mean():.2f} m"
    # robot makes real progress along the route using fused localization
    assert xy[:, 0].max() > 25.0, f"max x = {xy[:, 0].max():.1f}"
    # VIO tracked features most of the ACTIVE run (after completion the
    # robot parks facing wherever it stopped; tracking there is irrelevant)
    tr = np.asarray(rep.trace.vio_tracked)
    active = ~np.asarray(rep.trace.done)
    active[:30] = False
    assert (tr[active] >= 8).mean() > 0.5, tr[::100]


def test_repeat_encoder_only_ablation(teach_result):
    res, cfg_gt, route = teach_result
    cfg = cfg_mod.encoder_only().replace(
        camera=cfg_gt.camera, map=cfg_gt.map, planner=cfg_gt.planner)
    scene = tiny_scene(drop_on_path=False)
    packed, wps, n_wps = pack_test_route(route, cfg)
    rep = jax.jit(lambda: run_repeat(
        scene, packed, res.teach_grid, wps, n_wps, cfg, n_ticks=1500))()
    xy = np.asarray(rep.trace.gt_xy)
    nav = np.asarray(rep.trace.nav_xy)
    from nclt_slam_tpu.fusion import REGIME_ENCODER
    assert (np.asarray(rep.trace.regime) == REGIME_ENCODER).all()
    # encoder drifts but still drives the route forward
    assert xy[:, 0].max() > 20.0


def test_checkpoint_resume_exact(teach_result):
    """Mid-rollout checkpoint -> resume continues bit-exactly (the aux
    capability the reference lacks: it can only rerun failed routes)."""
    import jax.numpy as jnp

    from nclt_slam_tpu.io.artifacts import load_checkpoint, save_checkpoint
    from nclt_slam_tpu.landmarks.store import init_store
    from nclt_slam_tpu.rollout.repeat import init_repeat_carry, repeat_step

    res, cfg, route = teach_result
    scene = tiny_scene(drop_on_path=False)
    packed, wps, n_wps = pack_test_route(route, cfg)
    store = init_store(cfg.landmarks)
    step = jax.jit(lambda c, t: repeat_step(
        c, t, scene, packed, res.teach_grid, store, cfg))

    carry = init_repeat_carry(packed, wps, n_wps, cfg)
    for t in range(40):
        carry, _ = step(carry, jnp.int32(t))

    ckpt = save_checkpoint(carry, "/tmp/resume_test/carry.ckpt")
    carry_a = carry
    carry_b = load_checkpoint(ckpt)

    for t in range(40, 60):
        carry_a, _ = step(carry_a, jnp.int32(t))
        carry_b, _ = step(carry_b, jnp.int32(t))
    assert np.allclose(np.asarray(carry_a.robot.xy),
                       np.asarray(carry_b.robot.xy), atol=0)
    assert int(carry_a.dispatch.idx) == int(carry_b.dispatch.idx)

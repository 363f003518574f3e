"""Batched campaign + multi-device sharding tests (virtual 8-dev CPU mesh)."""

import dataclasses

import jax
import numpy as np
import pytest

from nclt_slam_tpu import config as cfg_mod
from nclt_slam_tpu.eval.metrics import ate_rmse, procrustes_drift_2d, wp_coverage
from nclt_slam_tpu.parallel import route_mesh, sharded_campaign_repeat
from nclt_slam_tpu.rollout.campaign import (
    build_campaign,
    campaign_metrics,
    run_campaign_repeat,
    run_campaign_teach,
    teach_waypoints,
)


def small_cfg(base=None):
    base = base or cfg_mod.gt_localization()
    return base.replace(
        camera=dataclasses.replace(base.camera, ray_cols=16, ray_rows=12,
                                   ray_steps=32),
        map=dataclasses.replace(base.map, resolution=0.4),
        planner=dataclasses.replace(base.planner, window=48, path_len=64),
    )


@pytest.fixture(scope="module")
def mini_campaign():
    cfg = small_cfg()
    data = build_campaign(["01_road", "03_south"], cfg=cfg)
    teach = run_campaign_teach(data, cfg, 600)
    return cfg, data, teach


def test_campaign_teach_batched(mini_campaign):
    cfg, data, teach = mini_campaign
    assert teach.trace.gt_xy.shape[0] == 2
    gt = np.asarray(teach.trace.gt_xy)
    # both routes drove away from spawn
    for i in range(2):
        d = np.hypot(*(gt[i] - gt[i, 0]).T)
        assert d.max() > 20.0


def test_campaign_repeat_and_metrics(mini_campaign):
    cfg, data, teach = mini_campaign
    wps, n_wps = teach_waypoints(data, teach, cfg)
    rep = run_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg, 700)
    per_route, agg = campaign_metrics(data, rep, wps, n_wps, cfg)
    assert set(per_route) == {"01_road", "03_south"}
    assert agg["routes"] == 2
    for name, m in per_route.items():
        assert m["gt_samples"] == 700
        assert m["path_m"] > 10.0, f"{name} barely moved: {m}"
        assert m["drift_mean"] is not None and m["drift_mean"] < 0.01  # GT mode


def test_sharded_campaign_runs_on_mesh(mini_campaign):
    cfg, data, teach = mini_campaign
    assert len(jax.devices()) == 8
    mesh = route_mesh(8)
    wps, n_wps = teach_waypoints(data, teach, cfg)
    rep = sharded_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg,
                                  200, mesh=mesh)
    # padded to 8 routes
    assert rep.trace.gt_xy.shape[0] == 8
    gt = np.asarray(rep.trace.gt_xy)
    assert np.isfinite(gt).all()
    # route 0 and its replica pads agree (same inputs, same seed)
    assert np.allclose(gt[2], gt[3])


def test_sharded_campaign_with_stores_matches_unsharded(mini_campaign):
    """The ours stack sharded over 4 devices, WITH the teach landmark
    stores, equals the one-device run route by route (the mesh is a layout
    decision), and the stores reach the sharded matcher."""
    _, data, teach = mini_campaign
    cfg = small_cfg(cfg_mod.ours())
    wps, n_wps = teach_waypoints(data, teach, cfg)
    kw = dict(stores=teach.store, chunk=20, stop_when_done=False)
    one = run_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg, 40,
                              **kw)
    four = sharded_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg,
                                   40, mesh=route_mesh(4), **kw)
    assert four.trace.gt_xy.shape[:2] == (4, 40)     # padded to the mesh
    assert len(four.final.robot.xy.sharding.device_set) == 4
    g1 = np.asarray(one.trace.gt_xy)
    g4 = np.asarray(four.trace.gt_xy)
    assert np.allclose(g4[:2], g1, atol=1e-4), np.abs(g4[:2] - g1).max()
    assert np.array_equal(np.asarray(four.trace.anchor_reason)[:2],
                          np.asarray(one.trace.anchor_reason))
    # teach stores present: attempts find candidates (reason 1 would be
    # "no candidates", what empty stores give)
    reasons = np.asarray(four.trace.anchor_reason)[:2]
    tried = reasons[reasons >= 0]
    assert tried.size and (tried != 1).any(), np.unique(reasons)
    trimmed = jax.tree_util.tree_map(lambda x: np.asarray(x)[:2], four)
    per4, _ = campaign_metrics(data, trimmed, wps, n_wps, cfg)
    per1, _ = campaign_metrics(data, one, wps, n_wps, cfg)
    for name in data.names:
        for k in ("cov_visited", "reached_final", "gt_samples"):
            assert per4[name][k] == per1[name][k], (name, k)


def _avals(tree):
    return [(jax.tree_util.keystr(k), x.shape, x.dtype, x.weak_type)
            for k, x in jax.tree_util.tree_leaves_with_path(tree)]


def test_carry_types_stable_across_chunks(mini_campaign):
    """Initial carries have the shapes, dtypes AND weak types the scan
    gives back, so each chunk program traces and compiles once — a
    weak-typed initial leaf made every campaign compile twice."""
    from nclt_slam_tpu.rollout.repeat import init_repeat_carry, run_repeat
    from nclt_slam_tpu.rollout.teach import init_teach_carry

    cfg, data, teach = mini_campaign
    init_t = jax.vmap(lambda rt: init_teach_carry(rt, cfg))(data.routes)
    assert _avals(init_t) == _avals(teach.final)

    one = jax.tree_util.tree_map(lambda x: x[0], (
        data.scenes_repeat, data.routes, teach.teach_grid, teach.store))
    sc, rt, tg, st = one
    ours = small_cfg(cfg_mod.ours())
    init_r = jax.eval_shape(
        lambda rt: init_repeat_carry(rt, rt.wps, rt.n_wps, ours), rt)
    out_r = jax.eval_shape(
        lambda c: run_repeat(sc, rt, tg, rt.wps, rt.n_wps, ours, 2,
                             store=st, carry=c).final, init_r)
    assert _avals(init_r) == _avals(out_r)


def test_eval_primitives():
    rng = np.random.RandomState(0)
    gt = np.cumsum(rng.normal(size=(200, 2)), 0)
    # rotated + translated copy should align to ~0 ATE
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    est = gt @ R.T + np.array([5.0, -3.0])
    assert ate_rmse(est, gt) < 1e-4

    # procrustes drift on a reflected trajectory still aligns
    vio = np.column_stack([gt @ R.T * np.array([1, -1]), np.zeros(len(gt))])
    d_max, d_mean = procrustes_drift_2d(vio, gt)
    assert d_mean < 1e-3

    # directional coverage: a GT trace that only drives the outbound leg
    # must NOT credit the return-half WPs (the whole point of the split)
    wps = np.array([[0.0, 0], [4, 0], [8, 0], [12, 0], [8, 0.1], [4, 0.1], [0, 0.1]])
    gt_path = np.column_stack([np.linspace(0, 12, 50), np.zeros(50)])
    v, t, _ = wp_coverage(gt_path, wps, (12.0, 0.0))
    assert t == 7
    assert v == 4  # outbound WPs only


def test_ablation_axis(mini_campaign):
    """Obstacle ablation = extra batch entries with drops masked out."""
    import jax.numpy as jnp

    from nclt_slam_tpu.rollout.campaign import expand_for_ablations

    cfg, data, teach = mini_campaign
    wps, n_wps = teach_waypoints(data, teach, cfg)
    exp, tg, wp, nw, st, labels = expand_for_ablations(
        data, teach.teach_grid, wps, n_wps)
    assert len(labels) == 4
    assert exp.routes.spawn.shape[0] == 4
    # clean entries have all drop slots invalid
    v = np.asarray(exp.scenes_repeat.valid)
    dm = np.asarray(exp.scenes_repeat.drop_mask)
    assert not (v[2:] & dm[2:]).any()
    rep = run_campaign_repeat(exp, tg, wp, nw, cfg, 150)
    assert rep.trace.gt_xy.shape[0] == 4
    assert bool(jnp.isfinite(rep.trace.gt_xy).all())

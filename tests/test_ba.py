"""Sliding-window BA: convergence on a synthetic window + gauge handling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nclt_slam_tpu.config import DEFAULT
from nclt_slam_tpu.core.quat import quat_conj, quat_from_yaw, quat_mul, quat_to_mat, so3_exp
from nclt_slam_tpu.vio.ba import BAProblem, _project_point, solve_ba

CFG = DEFAULT


def make_problem(K=6, P=64, pose_noise=0.15, rot_noise=0.03, pt_noise=0.2,
                 seed=0):
    rng = np.random.RandomState(seed)
    gt_pos = np.stack([np.linspace(0, 5, K),
                       0.2 * np.sin(np.linspace(0, 2, K)),
                       np.full(K, 0.5)], -1)
    gt_quat = np.asarray(quat_from_yaw(jnp.asarray(np.linspace(0, 0.4, K))))
    pts = np.stack([rng.uniform(3, 14, P), rng.uniform(-6, 6, P),
                    rng.uniform(0.2, 2.5, P)], -1)

    obs_uv = np.zeros((K, P, 2))
    obs_z = np.zeros((K, P))
    obs_w = np.zeros((K, P))
    for k in range(K):
        for p in range(P):
            uv, z = _project_point(jnp.asarray(gt_pos[k]),
                                   jnp.asarray(gt_quat[k]),
                                   jnp.asarray(pts[p]), CFG.camera)
            uv = np.asarray(uv)
            z = float(z)
            if 0 < uv[0] < 640 and 0 < uv[1] < 480 and 0.5 < z < 15:
                obs_uv[k, p] = uv + rng.normal(0, 0.5, 2)
                obs_z[k, p] = z * (1 + rng.normal(0, 0.01))
                obs_w[k, p] = 1.0

    rel_dp = np.zeros((K - 1, 3))
    rel_dq = np.zeros((K - 1, 4))
    for k in range(K - 1):
        Ri = np.asarray(quat_to_mat(jnp.asarray(gt_quat[k])))
        rel_dp[k] = Ri.T @ (gt_pos[k + 1] - gt_pos[k])
        rel_dq[k] = np.asarray(quat_mul(quat_conj(jnp.asarray(gt_quat[k])),
                                        jnp.asarray(gt_quat[k + 1])))

    pos0 = np.array(gt_pos + rng.normal(0, pose_noise, (K, 3)))
    pos0[0] = gt_pos[0]
    quat0 = np.array(jax.vmap(lambda q, d: quat_mul(q, so3_exp(d)))(
        jnp.asarray(gt_quat), jnp.asarray(rng.normal(0, rot_noise, (K, 3)))))
    quat0[0] = gt_quat[0]
    pts0 = pts + rng.normal(0, pt_noise, (P, 3))

    prob = BAProblem(
        kf_pos=jnp.asarray(pos0, jnp.float32),
        kf_quat=jnp.asarray(quat0, jnp.float32),
        points=jnp.asarray(pts0, jnp.float32),
        obs_uv=jnp.asarray(obs_uv, jnp.float32),
        obs_z=jnp.asarray(obs_z, jnp.float32),
        obs_w=jnp.asarray(obs_w, jnp.float32),
        rel_dp=jnp.asarray(rel_dp, jnp.float32),
        rel_dq=jnp.asarray(rel_dq, jnp.float32),
        w_rel=jnp.float32(100.0))
    return prob, gt_pos, gt_quat, pts, pos0, pts0


def test_ba_converges():
    prob, gt_pos, gt_quat, pts, pos0, pts0 = make_problem()
    res = jax.jit(lambda p: solve_ba(p, CFG.camera, CFG.vio, iters=10))(prob)
    pe0 = np.linalg.norm(pos0 - gt_pos, axis=-1)
    pe1 = np.linalg.norm(np.asarray(res.kf_pos) - gt_pos, axis=-1)
    assert pe1.max() < 0.05, (pe0, pe1)
    le1 = np.linalg.norm(np.asarray(res.points) - pts, axis=-1).mean()
    assert le1 < 0.1
    assert np.isfinite(float(res.final_cost))


def test_ba_respects_gauge_prior():
    prob, gt_pos, *_ = make_problem(seed=3)
    res = jax.jit(lambda p: solve_ba(p, CFG.camera, CFG.vio, iters=10))(prob)
    # KF0 was initialized at GT and pinned by the prior — it must not move
    assert np.linalg.norm(np.asarray(res.kf_pos[0]) - gt_pos[0]) < 0.02


def test_ba_vmaps_over_windows():
    """The BA must vmap over a batch of windows (campaign-scale solves)."""
    probs = []
    for s in range(3):
        p, *_ = make_problem(seed=s)
        probs.append(p)
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *probs)
    f = jax.jit(jax.vmap(lambda p: solve_ba(p, CFG.camera, CFG.vio, iters=5)))
    out = f(batch)
    assert out.kf_pos.shape == (3, 6, 3)
    assert bool(jnp.isfinite(out.kf_pos).all())


@pytest.mark.parametrize("K,P", [(6, 40), (10, 48), (10, 128), (16, 64)])
def test_ba_window_sizes(K, P):
    """Rollout-scale window shapes (window_kf x KF_OBS) converge from a
    perturbed start toward the true poses and points."""
    prob, gt_pos, _, pts, pos0, pts0 = make_problem(K=K, P=P, seed=K + P)
    res = jax.jit(lambda p: solve_ba(p, CFG.camera, CFG.vio, iters=10))(prob)
    pe0 = np.linalg.norm(pos0 - gt_pos, axis=-1).mean()
    pe1 = np.linalg.norm(np.asarray(res.kf_pos) - gt_pos, axis=-1)
    assert np.isfinite(pe1).all()
    assert pe1.mean() < 0.25 * pe0, (pe0, pe1)
    assert pe1.max() < 0.05, pe1
    le0 = np.linalg.norm(pts0 - pts, axis=-1).mean()
    le1 = np.linalg.norm(np.asarray(res.points) - pts, axis=-1).mean()
    assert le1 < 0.5 * le0, (le0, le1)


def test_ba_point_prior():
    """The per-point position prior pins landmarks to their input
    estimates: a strong prior keeps them there, none lets them move."""
    prob, *_ = make_problem(seed=5, P=40)
    solve = jax.jit(lambda p: solve_ba(p, CFG.camera, CFG.vio, iters=6))
    free = solve(prob)
    pinned = solve(prob._replace(pt_prior_w=jnp.full((40,), 1e4,
                                                     jnp.float32)))
    move_free = np.linalg.norm(np.asarray(free.points - prob.points), axis=-1)
    move_pin = np.linalg.norm(np.asarray(pinned.points - prob.points), axis=-1)
    assert move_pin.mean() < 0.25 * move_free.mean(), (move_pin.mean(),
                                                       move_free.mean())
    assert np.isfinite(np.asarray(pinned.kf_pos)).all()


def test_ba_batched_equals_single():
    """vmap over windows is a pure batching decision: each window's
    solution equals its own unbatched solve."""
    probs = [make_problem(K=10, P=48, seed=s)[0] for s in range(2)]
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *probs)
    f = lambda p: solve_ba(p, CFG.camera, CFG.vio, iters=6)  # noqa: E731
    out = jax.jit(jax.vmap(f))(batch)
    for i, p in enumerate(probs):
        one = jax.jit(f)(p)
        np.testing.assert_allclose(out.kf_pos[i], one.kf_pos, atol=1e-4)
        np.testing.assert_allclose(out.points[i], one.points, atol=1e-3)

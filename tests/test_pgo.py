"""Junction-reduced PGO: the fused single-program solver and the host path.

Capability reference: the reference's PoseGraphOptimizer2D
(datasets/nclt/src/slam/loop_closure.py:136).  The fast path must agree
with the dense optimizer it replaces at km scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nclt_slam_tpu.datasets.slam.loop_closure import (
    PoseGraph2D,
    optimize_pose_graph,
    optimize_pose_graph_fast,
    reduce_pose_graph,
)


def _two_lap_graph(K=240, seed=3, n_loops=4):
    """Noisy-odometry two-lap circle with exact loop measurements."""
    rng = np.random.RandomState(seed)
    th_gt = np.linspace(0, 4 * np.pi, K)
    R = 20.0
    gt = np.stack([R * np.cos(th_gt), R * np.sin(th_gt),
                   th_gt + np.pi / 2], -1)
    odo = []
    for k in range(K - 1):
        c, s = np.cos(gt[k, 2]), np.sin(gt[k, 2])
        d = gt[k + 1, :2] - gt[k, :2]
        m = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                      gt[k + 1, 2] - gt[k, 2]])
        m[:2] += rng.normal(0, 0.02, 2) + 0.004     # noise + bias
        m[2] += rng.normal(0, 0.002)
        odo.append(m)
    odo = np.asarray(odo, np.float32)
    poses = np.zeros((K, 3), np.float32)
    poses[0] = gt[0]
    for k in range(K - 1):
        c, s = np.cos(poses[k, 2]), np.sin(poses[k, 2])
        poses[k + 1] = (poses[k, 0] + c * odo[k, 0] - s * odo[k, 1],
                        poses[k, 1] + s * odo[k, 0] + c * odo[k, 1],
                        poses[k, 2] + odo[k, 2])
    L = n_loops + 2
    li = np.zeros(L, np.int32)
    lj = np.zeros(L, np.int32)
    lv = np.zeros(L, bool)
    lm = np.zeros((L, 3), np.float32)
    for e in range(n_loops):
        i = 5 + e * 30
        j = min(i + K // 2, K - 1)
        li[e], lj[e], lv[e] = i, j, True
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        d = gt[j, :2] - gt[i, :2]
        lm[e] = (c * d[0] + s * d[1], -s * d[0] + c * d[1],
                 gt[j, 2] - gt[i, 2])
    graph = PoseGraph2D(
        poses=jnp.asarray(poses), odo_meas=jnp.asarray(odo),
        loop_i=jnp.asarray(li), loop_j=jnp.asarray(lj),
        loop_meas=jnp.asarray(lm), loop_valid=jnp.asarray(lv))
    return graph, gt


def _err(sol, gt):
    return float(np.linalg.norm(np.asarray(sol)[:, :2] - gt[:, :2],
                                axis=1).mean())


def test_pgo_fast_matches_dense():
    graph, gt = _two_lap_graph()
    open_err = _err(graph.poses, gt)
    dense = optimize_pose_graph(graph, iters=15)
    fast = optimize_pose_graph_fast(graph, iters=15, backend="xla")
    # both close the loop: large error reduction vs the open chain
    assert _err(dense, gt) < 0.75 * open_err
    assert _err(fast, gt) < 0.75 * open_err
    # junction poses agree with the dense solve (the reduction is exact up
    # to the isotropic composed-weight approximation)
    _, _, junctions = reduce_pose_graph(graph, 1.0)
    d = np.linalg.norm(np.asarray(dense)[junctions, :2]
                       - np.asarray(fast)[junctions, :2], axis=1)
    assert d.max() < 0.6, d.max()


def test_pgo_fused_matches_host_path():
    """The single-program fused default (reduce+solve+expand on device,
    junctions padded to the static 2+2L bound) must agree with the host
    numpy-reduction path — including with invalid loop slots (the
    padded-junction code path).  Exact bit equality is not expected: the
    padded copies of the final pose add damped DOFs coupled to it, so the
    two damped-GN trajectories differ transiently (~cm at iters=15,
    vanishing with convergence)."""
    graph, gt = _two_lap_graph()          # 4 valid + 2 invalid loop slots
    host = np.asarray(optimize_pose_graph_fast(graph, iters=15,
                                               backend="xla"))
    fused = np.asarray(optimize_pose_graph_fast(graph, iters=15,
                                                backend="fused"))
    assert np.abs(host - fused).max() < 0.1, np.abs(host - fused).max()
    # and the fused path closes the loop as well as the dense oracle
    dense = optimize_pose_graph(graph, iters=15)
    _, _, junctions = reduce_pose_graph(graph, 1.0)
    d = np.linalg.norm(np.asarray(dense)[junctions, :2]
                       - fused[junctions, :2], axis=1)
    assert d.max() < 0.6, d.max()


def test_pgo_fused_no_valid_loops():
    graph, _ = _two_lap_graph()
    graph = graph._replace(loop_valid=jnp.zeros_like(graph.loop_valid))
    fused = np.asarray(optimize_pose_graph_fast(graph, iters=5))
    d = np.linalg.norm(fused[:, :2] - np.asarray(graph.poses)[:, :2], axis=1)
    assert d.max() < 0.05, d.max()


def test_pgo_unknown_backend_rejected():
    graph, _ = _two_lap_graph(K=40, n_loops=1)
    with pytest.raises(ValueError, match="unknown PGO backend"):
        optimize_pose_graph_fast(graph, iters=2, backend="pallas")


def test_pgo_fast_no_loops_keeps_chain():
    graph, _ = _two_lap_graph()
    graph = graph._replace(loop_valid=jnp.zeros_like(graph.loop_valid))
    fast = optimize_pose_graph_fast(graph, iters=5, backend="xla")
    # nothing to correct: the open chain comes back (up to GN noise on the
    # two junction endpoints)
    d = np.linalg.norm(np.asarray(fast)[:, :2]
                       - np.asarray(graph.poses)[:, :2], axis=1)
    assert d.max() < 0.05, d.max()


@pytest.mark.slow
def test_pgo_fast_2000_poses():
    graph, gt = _two_lap_graph(K=2000, n_loops=8)
    open_err = _err(graph.poses, gt)
    fast = optimize_pose_graph_fast(graph, iters=15, backend="xla")
    assert _err(fast, gt) < 0.6 * open_err

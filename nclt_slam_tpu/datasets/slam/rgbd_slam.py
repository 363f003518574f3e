"""RGB-D SLAM baseline — the Gazebo stack's RTAB-Map capability row.

The reference's Gazebo experiments benchmark RTAB-Map RGB-D SLAM on a
generated forest world (simulation/gazebo/experiments/02_slam_comparison/
README.md:30 — 9.23 m ATE on the forest route, where ORB-SLAM3 failed
outright; ugv_navigation RTAB-Map params).  This module carries that
capability into the framework: feature-based RGB-D frame-to-frame odometry,
a keyframe chain, appearance-based loop closure (bag-of-binary-words
signature, RTAB-Map's memory-retrieval analog) with 3-D/3-D geometric
verification, and the shared 2-D pose-graph backend — all running on worlds
generated by our own scene stack and frames rendered by our own sensor
model (no second engine).

Shape: the per-frame step (match + Kabsch) is one jitted function; the
sequence loop is host-side like datasets/slam/pipeline.py (sessions are
IO-bound streams).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from nclt_slam_tpu.datasets.slam.loop_closure import (
    PoseGraph2D,
    optimize_pose_graph,
)
from nclt_slam_tpu.landmarks.matcher import _kabsch
from nclt_slam_tpu.sensors.depth import R_BASE_CAM
from nclt_slam_tpu.sensors.features import cross_check_match


class RgbdSlamResult(NamedTuple):
    poses_open: np.ndarray      # (T, 3) x, y, yaw — odometry chain
    poses_opt: np.ndarray       # (T, 3) after loop-closed PGO
    loops: tuple                # (i_idx, j_idx, accepted)
    n_matches: np.ndarray       # (T,) frame-to-frame inlier counts


def _body_points(obs, cam):
    """Observed 3-D points in the body (FLU) frame."""
    t_bc = jnp.array([cam.cam_offset_fwd, 0.0, cam.cam_offset_up])
    return obs.p3d_cam @ R_BASE_CAM.T + t_bc[None, :]


def frame_rel_pose(obs_a, obs_b, cam):
    """Relative SE(2) pose of frame b in frame a via mutual descriptor
    matches + weighted 3-D Kabsch with one inlier re-weighting round
    (RTAB-Map's F2F visual odometry shape).  Returns
    (dx, dy, dyaw, n_inliers)."""
    m_idx, matched, _ = cross_check_match(obs_b.desc, obs_b.valid,
                                          obs_a.desc, obs_a.valid,
                                          return_dist=True)
    pa = _body_points(obs_a, cam)[m_idx]
    pb = _body_points(obs_b, cam)
    w0 = matched.astype(jnp.float32)
    R1, t1 = _kabsch(pb, pa, w0)
    r1 = jnp.linalg.norm(pb @ R1.T + t1[None, :] - pa, axis=-1)
    w1 = w0 * (r1 < 0.5)
    R2, t2 = _kabsch(pb, pa, w1)
    r2 = jnp.linalg.norm(pb @ R2.T + t2[None, :] - pa, axis=-1)
    inl = (w0 > 0) & (r2 < 0.3)
    ok = (inl.sum() >= 8) & jnp.isfinite(t2).all()
    dyaw = jnp.arctan2(R2[1, 0], R2[0, 0])
    return (jnp.where(ok, t2[0], 0.0), jnp.where(ok, t2[1], 0.0),
            jnp.where(ok, dyaw, 0.0), inl.sum().astype(jnp.int32), ok)


def frame_signature(obs) -> jax.Array:
    """Bag-of-binary-words appearance signature: mean bit occupancy of the
    frame's descriptors (256,) — rotation/ordering invariant, the
    retrieval key RTAB-Map builds from its visual vocabulary."""
    K, W = obs.desc.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((obs.desc[:, :, None] >> shifts) & jnp.uint32(1)).astype(
        jnp.float32).reshape(K, W * 32)
    w = obs.valid.astype(jnp.float32)[:, None]
    return (bits * w).sum(0) / jnp.maximum(w.sum(), 1.0)


def run_rgbd_slam(obs_seq, cam, loop_min_gap: int = 40,
                  sig_thresh: float = 0.05, max_loops: int = 16,
                  loop_min_inliers: int = 12) -> RgbdSlamResult:
    """Full RGB-D SLAM over a frame sequence (list/stack of Observations).

    Odometry: frame-to-frame Kabsch chain.  Loop closure: appearance
    signature shortlist (L1 distance below ``sig_thresh``), geometric
    verification by the same 3-D/3-D estimator at ``loop_min_inliers``,
    then the shared damped-GN 2-D PGO (loop_closure.optimize_pose_graph).
    """
    T = len(obs_seq)
    f_rel = jax.jit(lambda a, b: frame_rel_pose(a, b, cam))
    f_sig = jax.jit(frame_signature)

    poses = np.zeros((T, 3), np.float32)
    odo = np.zeros((max(T - 1, 1), 3), np.float32)
    n_matches = np.zeros(T, np.int32)
    sig0 = np.asarray(f_sig(obs_seq[0]))
    sigs = np.zeros((T, sig0.shape[0]), np.float32)
    sigs[0] = sig0
    for k in range(1, T):
        dx, dy, dyaw, n, ok = f_rel(obs_seq[k - 1], obs_seq[k])
        odo[k - 1] = (float(dx), float(dy), float(dyaw))
        n_matches[k] = int(n)
        c, s = np.cos(poses[k - 1, 2]), np.sin(poses[k - 1, 2])
        poses[k] = (poses[k - 1, 0] + c * float(dx) - s * float(dy),
                    poses[k - 1, 1] + s * float(dx) + c * float(dy),
                    poses[k - 1, 2] + float(dyaw))
        sigs[k] = np.asarray(f_sig(obs_seq[k]))

    # appearance retrieval: best-signature candidate pairs beyond min_gap
    d = np.abs(sigs[:, None, :] - sigs[None, :, :]).mean(-1)
    gap = np.abs(np.arange(T)[:, None] - np.arange(T)[None, :])
    d[gap <= loop_min_gap] = np.inf
    d[np.tril_indices(T)] = np.inf
    flat = np.argsort(d.reshape(-1))[:max_loops]
    li, lj = (flat // T).astype(np.int32), (flat % T).astype(np.int32)
    cand_ok = d.reshape(-1)[flat] < sig_thresh

    # geometric verification -> loop edges
    L = max_loops
    loop_meas = np.zeros((L, 3), np.float32)
    loop_valid = np.zeros(L, bool)
    for e in range(L):
        if not cand_ok[e]:
            continue
        dx, dy, dyaw, n, ok = f_rel(obs_seq[int(li[e])], obs_seq[int(lj[e])])
        if bool(ok) and int(n) >= loop_min_inliers:
            loop_meas[e] = (float(dx), float(dy), float(dyaw))
            loop_valid[e] = True

    graph = PoseGraph2D(
        poses=jnp.asarray(poses), odo_meas=jnp.asarray(odo),
        loop_i=jnp.asarray(li), loop_j=jnp.asarray(lj),
        loop_meas=jnp.asarray(loop_meas),
        loop_valid=jnp.asarray(loop_valid))
    opt = np.asarray(jax.jit(
        lambda g: optimize_pose_graph(g, iters=15))(graph))
    return RgbdSlamResult(poses_open=poses, poses_opt=opt,
                          loops=(li, lj, loop_valid), n_matches=n_matches)

"""Sliding-window visual-inertial bundle adjustment (the flagship solver).

Capability match for ORB-SLAM3's g2o local-mapping BA (SURVEY.md §2.3 /
hard part #1), reshaped for batched accelerators: fixed window of K keyframe poses and
P landmarks, dense block algebra, Schur complement over the landmarks, and
a Cholesky solve of the reduced (6K x 6K) camera system — all einsums and
small batched matrices that map onto matrix units, iterated a fixed
``iters`` count under ``lax.scan``.

Factors:
- Huber-weighted pixel reprojection + depth residuals per (kf, landmark)
  observation (mask-weighted; shapes never change)
- relative-pose factors between consecutive keyframes from IMU
  preintegration (or odometry), weighted by ``w_rel``
- a prior pinning keyframe 0 (gauge freedom)

Parameterization: pose k = (rotvec delta around a linearization quat,
translation), landmarks as world xyz.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nclt_slam_tpu.config import CameraConfig, VioConfig
from nclt_slam_tpu.core.quat import quat_conj, quat_mul, quat_to_mat, so3_exp, so3_log
from nclt_slam_tpu.sensors.depth import R_BASE_CAM


class BAProblem(NamedTuple):
    """Fixed-shape BA inputs.

    K keyframes, P landmarks.
    """

    kf_pos: jax.Array      # (K, 3) initial body positions
    kf_quat: jax.Array     # (K, 4) initial body orientations (xyzw)
    points: jax.Array      # (P, 3) initial landmark positions
    obs_uv: jax.Array      # (K, P, 2) observed pixels
    obs_z: jax.Array       # (K, P) observed camera-frame depth
    obs_w: jax.Array       # (K, P) observation weights (0 = unobserved)
    rel_dp: jax.Array      # (K-1, 3) measured relative translation (body i)
    rel_dq: jax.Array      # (K-1, 4) measured relative rotation
    w_rel: jax.Array       # () or (K-1,) relative-factor weight
    # optional per-point position prior anchoring each landmark at its input
    # estimate.  The rollout's map points are running-mean estimates over
    # every frame's re-observation (vio/tracker.py) — far more observations
    # than the window's <= K recorded rows.  Without the prior, BA re-fits
    # those points to the sparser historical sample and destroys
    # information (measured: raw VIO drift 0.09 -> 0.44 m).  Weight is in
    # the same units as one pixel^2 residual; None/0 = free point (the
    # synthetic-benchmark configuration).
    pt_prior_w: jax.Array | None = None  # (P,) or None


class BAResult(NamedTuple):
    kf_pos: jax.Array
    kf_quat: jax.Array
    points: jax.Array
    final_cost: jax.Array


def _project_point(pos, q, X, cam: CameraConfig):
    """Body pose -> (uv, z) of world point X."""
    R_wb = quat_to_mat(q)
    t_bc = jnp.array([cam.cam_offset_fwd, 0.0, cam.cam_offset_up])
    p_base = R_wb.T @ (X - pos) - t_bc
    p_cam = R_BASE_CAM.T @ p_base
    z = jnp.maximum(p_cam[2], 0.1)
    uv = jnp.array([cam.fx * p_cam[0] / z + cam.cx,
                    cam.fy * p_cam[1] / z + cam.cy])
    return uv, p_cam[2]


def _residual_one(dpose, dX, pos, q, X, uv_obs, z_obs, cam: CameraConfig):
    """3-vector residual for one (kf, point) pair, as a function of the
    increments (dpose (6,), dX (3,)) — linearized via jacfwd."""
    q_new = quat_mul(q, so3_exp(dpose[:3]))
    pos_new = pos + dpose[3:]
    uv, z = _project_point(pos_new, q_new, X + dX, cam)
    # depth whitened by the stereo noise model sigma_z ~ k*z^2 (same model
    # the sensor applies, sensors/features.py) and expressed in
    # pixel-equivalent units (1 sigma == 2 px) so the Huber scale is shared.
    # A constant heavy weight here let far-point depth noise (sigma 0.3-1 m
    # beyond 10 m) dominate the whole window and actively degrade the pose.
    sigma_z = jnp.maximum(0.02, cam.depth_noise_rel_per_m * z_obs * z_obs)
    return jnp.concatenate([uv - uv_obs,
                            (2.0 * (z - z_obs) / sigma_z)[None]])


def _inv3x3(A):
    """Closed-form batched 3x3 inverse via the adjugate — pure elementwise
    arithmetic (no LAPACK-style lowering), exactly what the VPU wants for
    (P, 3, 3) landmark blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], -1),
        jnp.stack([A21, A22, A23], -1),
        jnp.stack([A31, A32, A33], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def solve_ba(prob: BAProblem, cam: CameraConfig, cfg: VioConfig,
             iters: int | None = None) -> BAResult:
    K = prob.kf_pos.shape[0]
    P = prob.points.shape[0]
    n_iter = iters or cfg.gn_iters
    damping = cfg.lm_damping

    res_fn = jax.vmap(jax.vmap(
        _residual_one,
        in_axes=(None, None, None, None, 0, 0, 0, None)),  # over points
        in_axes=(None, None, 0, 0, None, 0, 0, None))      # over keyframes

    zero6 = jnp.zeros(6)
    zero3 = jnp.zeros(3)

    jac_pose = jax.vmap(jax.vmap(
        lambda pos, q, X, uv, z: jax.jacfwd(
            lambda d: _residual_one(d, zero3, pos, q, X, uv, z, cam))(zero6),
        in_axes=(None, None, 0, 0, 0)),
        in_axes=(0, 0, None, 0, 0))
    jac_point = jax.vmap(jax.vmap(
        lambda pos, q, X, uv, z: jax.jacfwd(
            lambda d: _residual_one(zero6, d, pos, q, X, uv, z, cam))(zero3),
        in_axes=(None, None, 0, 0, 0)),
        in_axes=(0, 0, None, 0, 0))

    def rel_residual(pos_i, q_i, pos_j, q_j, dp_meas, dq_meas):
        """Relative-pose factor residual (6,) between consecutive KFs."""
        dq_est = quat_mul(quat_conj(q_i), q_j)
        dp_est = quat_to_mat(q_i).T @ (pos_j - pos_i)
        r_rot = so3_log(quat_mul(quat_conj(dq_meas), dq_est))
        r_t = dp_est - dp_meas
        return jnp.concatenate([r_rot, r_t])

    def gn_step(carry, _):
        pos, quat, pts = carry

        r = res_fn(zero6, zero3, pos, quat, pts, prob.obs_uv, prob.obs_z,
                   cam)                                        # (K, P, 3)
        Jp = jac_pose(pos, quat, pts, prob.obs_uv, prob.obs_z)  # (K, P, 3, 6)
        Jl = jac_point(pos, quat, pts, prob.obs_uv, prob.obs_z)  # (K, P, 3, 3)

        # Huber on the pixel residual + separate robust cap on the whitened
        # depth component (3 sigma = 6 px-equivalent) so one gross depth
        # outlier cannot steer the window
        r_norm = jnp.linalg.norm(r[..., :2], axis=-1)
        hub = jnp.where(r_norm <= cfg.huber_px, 1.0,
                        cfg.huber_px / jnp.maximum(r_norm, 1e-6))
        rz = jnp.abs(r[..., 2])
        hub_z = jnp.where(rz <= 6.0, 1.0, 6.0 / jnp.maximum(rz, 1e-6))
        w = prob.obs_w * hub * hub_z                            # (K, P)

        Jpw = Jp * w[..., None, None]
        Jlw = Jl * w[..., None, None]

        # normal-equation blocks (all einsums)
        H_pp = jnp.einsum("kpri,kprj->kij", Jpw, Jp)            # (K, 6, 6)
        H_ll = jnp.einsum("kpri,kprj->pij", Jlw, Jl)            # (P, 3, 3)
        H_pl = jnp.einsum("kpri,kprj->kpij", Jpw, Jl)           # (K, P, 6, 3)
        g_p = jnp.einsum("kpri,kpr->ki", Jpw, r)                # (K, 6)
        g_l = jnp.einsum("kpri,kpr->pi", Jlw, r)                # (P, 3)

        # relative-pose factors -> pose-block tridiagonal terms
        r_rel = jax.vmap(rel_residual)(
            pos[:-1], quat[:-1], pos[1:], quat[1:],
            prob.rel_dp, prob.rel_dq)                           # (K-1, 6)
        Ji = jax.vmap(lambda pi, qi, pj, qj, dp, dq: jax.jacfwd(
            lambda d: rel_residual(pi + d[3:],
                                   quat_mul(qi, so3_exp(d[:3])),
                                   pj, qj, dp, dq))(zero6))(
            pos[:-1], quat[:-1], pos[1:], quat[1:],
            prob.rel_dp, prob.rel_dq)                           # (K-1, 6, 6)
        Jj = jax.vmap(lambda pi, qi, pj, qj, dp, dq: jax.jacfwd(
            lambda d: rel_residual(pi, qi, pj + d[3:],
                                   quat_mul(qj, so3_exp(d[:3])),
                                   dp, dq))(zero6))(
            pos[:-1], quat[:-1], pos[1:], quat[1:],
            prob.rel_dp, prob.rel_dq)

        w_rel = jnp.broadcast_to(jnp.asarray(prob.w_rel), (K - 1,))

        # assemble the dense reduced camera system in (K, K, 6, 6) block
        # form — batched scatter-adds, not a serialized update loop (the
        # loop version lowered to 6K dependent dynamic_update_slices and
        # dominated the launch at covisibility window sizes)
        kk = jnp.arange(K)
        ii = jnp.arange(K - 1)
        Hb = jnp.zeros((K, K, 6, 6))
        Hb = Hb.at[kk, kk].add(H_pp)
        g = jnp.zeros((K, 6)).at[kk].add(g_p)

        wJi = w_rel[:, None, None] * Ji
        Hb = Hb.at[ii, ii].add(jnp.einsum("kri,krj->kij", wJi, Ji))
        Hb = Hb.at[ii + 1, ii + 1].add(jnp.einsum(
            "kri,krj->kij", w_rel[:, None, None] * Jj, Jj))
        Hb = Hb.at[ii, ii + 1].add(jnp.einsum("kri,krj->kij", wJi, Jj))
        Hb = Hb.at[ii + 1, ii].add(jnp.einsum(
            "kri,krj->kij", w_rel[:, None, None] * Jj, Ji))
        g = g.at[ii].add(jnp.einsum("kri,kr->ki", wJi, r_rel))
        g = g.at[ii + 1].add(jnp.einsum(
            "kri,kr->ki", w_rel[:, None, None] * Jj, r_rel))

        # gauge prior on KF 0
        PRIOR_W = 1e4
        Hb = Hb.at[0, 0].add(PRIOR_W * jnp.eye(6))

        H = Hb.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
        g = g.reshape(6 * K)

        # per-point position prior toward the input estimate (see BAProblem)
        if prob.pt_prior_w is not None:
            H_ll = H_ll + prob.pt_prior_w[:, None, None] * jnp.eye(3)[None]
            g_l = g_l + prob.pt_prior_w[:, None] * (pts - prob.points)

        # Schur complement over landmarks:
        # S = H - sum_p  B_p A_p^-1 B_p^T  with B_p (6K, 3)
        H_ll_inv = _inv3x3(H_ll + damping * jnp.eye(3)[None])   # (P, 3, 3)
        B = H_pl.transpose(1, 0, 2, 3).reshape(P, 6 * K, 3)     # (P, 6K, 3)
        C = jnp.einsum("pai,pij->paj", B, H_ll_inv)             # (P, 6K, 3)
        # big-contraction matmul form: (6K, 3P) @ (3P, 6K)
        S_corr = jnp.einsum("paj,pbj->ab", C, B)
        g_corr = jnp.einsum("paj,pj->a", C, g_l)

        S = H - S_corr + damping * jnp.eye(6 * K)
        rhs = -(g - g_corr)
        # S is symmetric positive definite (damped Schur complement):
        # Cholesky + two triangular solves, cheaper than LU
        L = jnp.linalg.cholesky(S)
        y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
        delta_p = jnp.nan_to_num(
            jax.scipy.linalg.solve_triangular(L.T, y, lower=False),
            nan=0.0, posinf=0.0, neginf=0.0)

        # back-substitute landmarks: Δl_p = -A_p^-1 (g_l_p + B_p^T Δp)
        Bt_dp = jnp.einsum("pai,a->pi", B, delta_p)             # (P, 3)
        delta_l = -jnp.einsum("pij,pj->pi", H_ll_inv, g_l + Bt_dp)

        dposes = delta_p.reshape(K, 6)
        pos_new = pos + dposes[:, 3:]
        quat_new = jax.vmap(lambda q, d: quat_mul(q, so3_exp(d)))(
            quat, dposes[:, :3])
        quat_new = quat_new / jnp.linalg.norm(quat_new, axis=-1, keepdims=True)
        pts_new = pts + delta_l

        cost = (w * (r ** 2).sum(-1)).sum() + (w_rel[:, None] * r_rel ** 2).sum()
        return (pos_new, quat_new, pts_new), cost

    (pos, quat, pts), costs = jax.lax.scan(
        gn_step, (prob.kf_pos, prob.kf_quat, prob.points), None,
        length=n_iter)
    return BAResult(kf_pos=pos, kf_quat=quat, points=pts,
                    final_cost=costs[-1])

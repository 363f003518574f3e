"""RGB-D-inertial visual odometry — capability match for ORB-SLAM3's
tracking front end (SURVEY.md §2.3: feature extract + match, IMU
preintegration, motion-only optimization, map management, lost detection).

Per 10 Hz vision frame:
1. predict body state by IMU preintegration over the 200 Hz block
   (or constant velocity for the RGB-D-only ablation)
2. match the frame's descriptors to the persistent map (mutual Hamming)
3. motion-only Gauss-Newton on the 6-dof body pose: Huber-weighted pixel
   reprojection + depth residuals of matched map points (ORB-SLAM3's
   Optimizer::PoseOptimization equivalent), Jacobians via jacfwd
4. insert unmatched features as new map points back-projected through the
   *estimated* pose (so mapping error feeds back — realistic drift)
5. tracking-lost detection when matches collapse (feeds the relay's
   freeze/lost fallback)

The VIO world frame is the spawn body frame (FLU).  ``emit_slam_pose``
converts to the ORB-SLAM3 convention (camera pose in the first-camera
world) that the v55 alignment consumes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nclt_slam_tpu.config import CameraConfig, VioConfig
from nclt_slam_tpu.core.quat import (
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_mat,
    so3_exp,
    so3_log,
)
from nclt_slam_tpu.sensors.depth import R_BASE_CAM
from nclt_slam_tpu.sensors.features import Observation, cross_check_match
from nclt_slam_tpu.vio.preintegration import empty_preint, integrate_block, propagate

MAP_CAP = 384
# Stored observations per keyframe = the live-frame feature cap
# (LandmarkConfig.max_obs_features): every tracked feature becomes a
# local-BA factor, so the window is covisibility-scale like ORB-SLAM3's
# local-mapping BA (SURVEY §2.3 hard part #1) rather than a thin sample.
KF_OBS = 192


class VioAux(NamedTuple):
    """Per-frame tracking telemetry (traced by the rollout for post-hoc
    health analysis — the analog of ORB-SLAM3's per-frame log line)."""

    n_desc: jax.Array   # descriptor (mutual-Hamming) matches, pre-proj-gate
    n_match: jax.Array  # matches surviving the projection gate
    n_ins: jax.Array    # map points inserted this frame
    flags: jax.Array    # bit0 enough, bit1 finite, bit2 plausible, bit3 lost


class VioState(NamedTuple):
    pos: jax.Array        # (3,) body position in VIO world (spawn frame)
    vel: jax.Array        # (3,)
    q: jax.Array          # (4,) world_from_body
    map_xyz: jax.Array    # (MAP_CAP, 3) map points (VIO world)
    map_desc: jax.Array   # (MAP_CAP, W) uint32
    map_valid: jax.Array  # (MAP_CAP,)
    map_age: jax.Array    # (MAP_CAP,) frames since last seen
    map_obs: jax.Array    # (MAP_CAP,) observation count (refinement weight)
    next_slot: jax.Array  # () int32 ring insertion cursor
    lost: jax.Array       # () bool
    implaus_streak: jax.Array  # () int32 consecutive implausible-GN frames
    n_tracked: jax.Array  # () int32 matches in the last frame
    frames: jax.Array     # () int32
    # --- sliding keyframe window (local BA) ---
    kf_pos: jax.Array       # (K, 3)
    kf_quat: jax.Array      # (K, 4)
    kf_valid: jax.Array     # (K,)
    kf_ptr: jax.Array       # () int32 ring cursor (newest = ptr-1)
    kf_obs_slot: jax.Array  # (K, KF_OBS) map slot ids
    kf_obs_uv: jax.Array    # (K, KF_OBS, 2)
    kf_obs_z: jax.Array     # (K, KF_OBS)
    kf_obs_valid: jax.Array  # (K, KF_OBS)
    last_kf_pos: jax.Array  # (3,)
    # --- world-registration state (VioConfig snap_* model) ---
    emit_scale: jax.Array   # () reported-trajectory scale about the origin
    emit_off: jax.Array     # (3,) reported-trajectory translation offset
    dist_since_event: jax.Array  # () travel since the last backend event
    stress_streak: jax.Array     # () int32 consecutive stressed frames
    starve_streak: jax.Array     # () int32 consecutive match-starved frames


def init_vio(desc_words: int, window_kf: int = 10) -> VioState:
    K = window_kf
    return VioState(
        pos=jnp.zeros(3), vel=jnp.zeros(3),
        q=jnp.array([0.0, 0.0, 0.0, 1.0]),
        map_xyz=jnp.zeros((MAP_CAP, 3)),
        map_desc=jnp.zeros((MAP_CAP, desc_words), jnp.uint32),
        map_valid=jnp.zeros(MAP_CAP, bool),
        map_age=jnp.zeros(MAP_CAP, jnp.int32),
        map_obs=jnp.zeros(MAP_CAP, jnp.int32),
        next_slot=jnp.int32(0),
        lost=jnp.array(False),
        implaus_streak=jnp.int32(0),
        n_tracked=jnp.int32(0),
        frames=jnp.int32(0),
        kf_pos=jnp.zeros((K, 3)),
        kf_quat=jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0]), (K, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_ptr=jnp.int32(0),
        kf_obs_slot=jnp.zeros((K, KF_OBS), jnp.int32),
        kf_obs_uv=jnp.zeros((K, KF_OBS, 2)),
        kf_obs_z=jnp.zeros((K, KF_OBS)),
        kf_obs_valid=jnp.zeros((K, KF_OBS), bool),
        last_kf_pos=jnp.full(3, 1e9, jnp.float32),
        emit_scale=jnp.float32(1.0),
        emit_off=jnp.zeros(3),
        dist_since_event=jnp.float32(0.0),
        stress_streak=jnp.int32(0),
        starve_streak=jnp.int32(0),
    )


def _project(p_cam, cam: CameraConfig):
    z = jnp.maximum(p_cam[..., 2], 0.1)
    return jnp.stack([cam.fx * p_cam[..., 0] / z + cam.cx,
                      cam.fy * p_cam[..., 1] / z + cam.cy], -1)


def _pose_gn(pos0, q0, X_w, uv_obs, z_obs, w_pt, cam: CameraConfig,
             cfg: VioConfig, prior_pos=None, prior_q=None,
             w_prior_pos: float = 0.0, w_prior_rot: float = 0.0):
    """Motion-only GN: optimize 6-dof body pose against matched map points.

    X_w (M, 3) map points, uv_obs (M, 2), z_obs (M,) camera-frame depth,
    w_pt (M,) weights (0 for unmatched).  ``prior_*``/``w_prior_*`` add
    the inertial prior factor (pose pulled toward the preintegrated
    prediction — ORB-SLAM3's PoseInertialOptimization residual)."""

    def residuals(delta, pos, q):
        dq = so3_exp(delta[:3])
        q_new = quat_mul(q, dq)
        p_new = pos + delta[3:]
        R_wb = quat_to_mat(q_new)
        t_bc = jnp.array([cam.cam_offset_fwd, 0.0, cam.cam_offset_up])
        p_base = (X_w - p_new) @ R_wb - t_bc[None, :]
        p_cam = p_base @ R_BASE_CAM
        uv = _project(p_cam, cam)
        r_uv = (uv - uv_obs)                     # (M, 2) px
        # depth residual in px-equivalent units, weighted by the stereo
        # noise model (sigma_z grows quadratically with range, so far depth
        # readings contribute weakly — ORB-SLAM3's per-level sigma weighting)
        sigma_z = jnp.maximum(0.05, cam.depth_noise_rel_per_m * z_obs ** 2)
        r_z = (p_cam[:, 2] - z_obs) / sigma_z
        return jnp.concatenate([r_uv, r_z[:, None]], -1)  # (M, 3)

    def gn_iter(carry, _):
        pos, q = carry
        zero = jnp.zeros(6)
        r = residuals(zero, pos, q)              # (M, 3)
        J = jax.jacfwd(lambda d: residuals(d, pos, q))(zero)  # (M, 3, 6)

        # Huber weights on the pixel residual norm
        r_norm = jnp.linalg.norm(r[:, :2], axis=-1)
        hub = jnp.where(r_norm <= cfg.huber_px, 1.0,
                        cfg.huber_px / jnp.maximum(r_norm, 1e-6))
        w = (w_pt * hub)[:, None]

        Jw = J * w[..., None]
        H = jnp.einsum("mri,mrj->ij", Jw, J) + cfg.lm_damping * jnp.eye(6)
        g = jnp.einsum("mri,mr->i", Jw, r)
        if prior_pos is not None:
            # inertial prior: quadratic pull toward the predicted pose
            # (rotation block approximated with an identity Jacobian —
            # exact to first order in the small inter-frame rotation)
            r_rot_p = so3_log(quat_mul(quat_conj(prior_q), q))
            diag = jnp.concatenate([jnp.full(3, w_prior_rot),
                                    jnp.full(3, w_prior_pos)])
            H = H + jnp.diag(diag)
            g = g + diag * jnp.concatenate([r_rot_p, pos - prior_pos])
        delta = -jnp.linalg.solve(H, g)
        # trust region + NaN guard: a degenerate window must not poison the
        # state (maps to tracking-lost, the reference's crashed-SLAM case)
        delta = jnp.nan_to_num(delta, nan=0.0, posinf=0.0, neginf=0.0)
        nrm = jnp.linalg.norm(delta)
        delta = delta * jnp.minimum(1.0, 1.0 / (nrm + 1e-9))
        dq = so3_exp(delta[:3])
        return (pos + delta[3:], quat_mul(q, dq)), None

    (pos, q), _ = jax.lax.scan(gn_iter, (pos0, q0), None, length=cfg.gn_iters)
    return pos, q / jnp.linalg.norm(q)


def vio_frame(state: VioState, obs: Observation, imu_block_meas, dt_frame,
              gravity, cam: CameraConfig, cfg: VioConfig, use_imu: bool,
              key=None):
    """One VIO frame.  imu_block_meas: (S, 6) [accel | gyro] since the last
    frame.  ``key`` drives the stress-triggered backend-event model
    (VioConfig snap_*); None freezes the world registration (unit tests,
    deterministic probes).  Returns (state, slam_ok, aux)."""
    # ---- predict ----
    if use_imu:
        pre = integrate_block(
            empty_preint(), imu_block_meas[:, :3], imu_block_meas[:, 3:],
            dt_frame / imu_block_meas.shape[0])
        pos_pred, vel_pred, q_pred = propagate(
            state.pos, state.vel, state.q, pre, gravity)
    else:
        pos_pred = state.pos + state.vel * dt_frame
        vel_pred = state.vel
        q_pred = state.q

    # ---- match to map ----
    m_idx, matched, best_d = cross_check_match(
        obs.desc, obs.valid, state.map_desc, state.map_valid,
        return_dist=True)
    X = state.map_xyz[m_idx]

    # projection-guided gating (ORB-SLAM3 SearchByProjection): the match only
    # stands if the live feature lies near the map point's projection under
    # the PREDICTED pose — descriptor-aliased false matches (e.g. back-face
    # features of distant trees during a hairpin sweep) then cannot pull the
    # motion-only GN toward a divergent pose
    R_pred = quat_to_mat(q_pred)
    t_bc_g = jnp.array([cam.cam_offset_fwd, 0.0, cam.cam_offset_up])
    p_base_pred = (X - pos_pred[None, :]) @ R_pred - t_bc_g[None, :]
    p_cam_pred = p_base_pred @ R_BASE_CAM
    uv_pred = _project(p_cam_pred, cam)
    proj_ok = (jnp.linalg.norm(uv_pred - obs.uv, axis=-1) < cfg.proj_gate_px) \
        & (p_cam_pred[:, 2] > 0.1)
    n_desc = matched.sum()
    desc_matched = matched          # mutual Hamming matches, pre-proj-gate
    matched = matched & proj_ok

    n_match = matched.sum()
    w_pt = matched.astype(jnp.float32)

    # ---- motion-only GN (only meaningful with enough matches) ----
    # inertial prior only when the prediction IS inertial (VI mode);
    # pure-visual tracking (rgbd ablation) has no such factor
    use_prior = use_imu and cfg.use_inertial_prior
    w_pp = 1.0 / cfg.inertial_prior_pos_std ** 2 if use_prior else 0.0
    w_pr = 1.0 / cfg.inertial_prior_rot_std ** 2 if use_prior else 0.0
    pos_opt, q_opt = _pose_gn(pos_pred, q_pred, X, obs.uv, obs.p3d_cam[:, 2],
                              w_pt, cam, cfg,
                              prior_pos=pos_pred if use_prior else None,
                              prior_q=q_pred,
                              w_prior_pos=w_pp, w_prior_rot=w_pr)
    finite = jnp.isfinite(pos_opt).all() & jnp.isfinite(q_opt).all()
    # motion-model plausibility: a pose that jumps far from the prediction
    # in one frame is a tracking failure, not a measurement (ORB-SLAM3
    # rejects the frame); without this, fast-yaw transients (hairpin
    # turnarounds) briefly poison the map and the published pose
    plausible = jnp.linalg.norm(pos_opt - pos_pred) <= cfg.max_frame_jump_m
    # ... but the gate must not be ABSORBING: after an abrupt state error
    # (e.g. a rejected-in-hindsight BA correction, or re-entering the mapped
    # corridor after a loss) the PREDICTION is what's wrong, not the
    # measurement.  With a healthy match count agreeing on a far pose for
    # several consecutive frames, accept it — ORB-SLAM3's relocalization-
    # then-resume behavior, by consensus instead of DBoW.
    consensus = finite & (~plausible) & (n_match >= 30)
    implaus_streak = jnp.where(consensus, state.implaus_streak + 1,
                               jnp.int32(0))
    plausible = plausible | (consensus & (implaus_streak >= 3))
    enough = (n_match >= 8) & finite & plausible
    # When tracking is lost, FREEZE the emitted position instead of
    # dead-reckoning on noisy IMU (which diverges quadratically) — this is
    # ORB-SLAM3's observable behavior at the /tmp/slam_pose.txt interface
    # and what the relay's freeze/stale detection is tuned against.
    # Orientation, however, keeps integrating the gyro (drift is slow):
    # without it the projection gate would reject every match after any
    # rotation while lost and relocalization on map revisit — ORB-SLAM3's
    # recovery path — could never fire.
    pos_new = jnp.where(enough, pos_opt, state.pos)
    q_new = jnp.where(enough, q_opt,
                      q_pred / jnp.linalg.norm(q_pred))

    # velocity from pose difference blended with inertial prediction;
    # magnitude-clamped so a large accepted correction (consensus override,
    # relocalization) cannot launch the next frame's inertial prediction
    vel_vis = (pos_new - state.pos) / dt_frame
    vel_new = jnp.where(enough, 0.7 * vel_vis + 0.3 * vel_pred,
                        jnp.zeros(3))
    vel_new = vel_new * jnp.minimum(
        1.0, 2.0 / (jnp.linalg.norm(vel_new) + 1e-9))

    # ---- relocalization (ORB-SLAM3 Relocalization(), fixed-shape form) ----
    # While lost the pose is frozen, so the projection gate can never
    # re-admit matches once the robot has moved on.  Instead: descriptor-
    # only mutual matches against the persistent map, 3-D/3-D weighted
    # Kabsch (map <- body-frame points) with one inlier reweighting round;
    # accepted on inlier count + residual, it re-seeds the pose anywhere on
    # the mapped corridor (the T&R return leg revisits it by design).
    from nclt_slam_tpu.core.quat import mat_to_quat
    from nclt_slam_tpu.landmarks.matcher import _kabsch

    p_base_obs = obs.p3d_cam @ R_BASE_CAM.T + t_bc_g[None, :]
    w0 = desc_matched.astype(jnp.float32)
    R1, t1 = _kabsch(p_base_obs, X, w0)
    r1 = jnp.linalg.norm(p_base_obs @ R1.T + t1[None, :] - X, axis=-1)
    R2, t2 = _kabsch(p_base_obs, X, w0 * (r1 < 1.0))
    r2 = jnp.linalg.norm(p_base_obs @ R2.T + t2[None, :] - X, axis=-1)
    inl = desc_matched & (r2 < 0.5)
    reloc_ok = (inl.sum() >= 20) & jnp.isfinite(t2).all() & \
        jnp.isfinite(R2).all()
    reloc = state.lost & reloc_ok & (~enough)
    pos_new = jnp.where(reloc, t2, pos_new)
    q_new = jnp.where(reloc, mat_to_quat(R2), q_new)
    vel_new = jnp.where(reloc, jnp.zeros(3), vel_new)

    # ---- map maintenance ----
    R_wb = quat_to_mat(q_new)
    t_bc = jnp.array([cam.cam_offset_fwd, 0.0, cam.cam_offset_up])
    p_base = obs.p3d_cam @ R_BASE_CAM.T + t_bc[None, :]
    X_new = p_base @ R_wb.T + pos_new[None, :]

    # multi-view refinement: a matched map point averages its
    # re-observations (running mean, weight 1/(1+n_obs)) — the streaming
    # equivalent of ORB-SLAM3 refining each point from all its observations.
    # cross_check matches are mutual-NN, so m_idx is injective over matched
    # rows (no scatter conflicts).  Only refine while tracking is healthy,
    # so a diverged pose can't drag the map.
    refine = matched & enough
    alpha = 1.0 / (1.0 + state.map_obs[m_idx].astype(jnp.float32))
    X_refined = (1.0 - alpha[:, None]) * X + alpha[:, None] * X_new
    map_xyz = state.map_xyz.at[m_idx].set(
        jnp.where(refine[:, None], X_refined, state.map_xyz[m_idx]))
    map_obs = state.map_obs.at[m_idx].add(jnp.where(refine, 1, 0))

    # insert only genuinely NEW features: unmatched AND descriptor-novel
    # (re-inserting unmatched-but-known features floods the ring with
    # duplicates and churns live map points out).  Far points still become
    # map points (ORB-SLAM3 keeps them as bearing-only/monocular points
    # beyond ThDepth — dropping them starves forward geometry); their
    # unreliable depth is handled by the sigma_z-weighted depth residual.
    novel = best_d > 80
    insert = obs.valid & (~matched) & novel & (obs.p3d_cam[:, 2] > 0.3)
    # rank: insertable first; take as many slots as we allow per frame
    K_INS = 24
    order = jnp.argsort(~insert)
    take = order[:K_INS]
    ins_ok = insert[take] & enough
    # eviction priority: invalid slots first, then oldest-unseen; points
    # matched THIS frame are protected (ORB-SLAM3 culls stale points and
    # keeps tracked ones — a blind ring cursor can evict the very points
    # the tracker is standing on)
    protected = jnp.zeros(MAP_CAP, bool).at[m_idx].max(matched)
    evict = jnp.where(~state.map_valid, jnp.float32(1e9),
                      jnp.where(protected, jnp.float32(-1.0),
                                state.map_age.astype(jnp.float32)))
    _, slots = jax.lax.top_k(evict, K_INS)
    map_xyz = map_xyz.at[slots].set(
        jnp.where(ins_ok[:, None], X_new[take], map_xyz[slots]))
    map_desc = state.map_desc.at[slots].set(
        jnp.where(ins_ok[:, None], obs.desc[take], state.map_desc[slots]))
    map_valid = state.map_valid.at[slots].set(
        state.map_valid[slots] | ins_ok)
    map_obs = map_obs.at[slots].set(
        jnp.where(ins_ok, 1, map_obs[slots]))
    # bootstrap: first frame inserts regardless of tracking
    first = state.frames == 0
    boot_ok = insert[take] & first
    map_xyz = map_xyz.at[slots].set(
        jnp.where(boot_ok[:, None], X_new[take], map_xyz[slots]))
    map_desc = map_desc.at[slots].set(
        jnp.where(boot_ok[:, None], obs.desc[take], map_desc[slots]))
    map_valid = map_valid.at[slots].set(map_valid[slots] | boot_ok)
    map_obs = map_obs.at[slots].set(jnp.where(boot_ok, 1, map_obs[slots]))
    n_ins = (ins_ok | boot_ok).sum()

    # ages: matched points refresh, fresh insertions start at 0, others age
    # out after 600 frames (60 s).  While LOST the whole map is frozen in
    # time — expiring it would make relocalization (map revisit) impossible;
    # ORB-SLAM3 likewise keeps the map alive while the tracker is lost.
    age = state.map_age + jnp.where(state.lost, 0, 1)
    age = age.at[m_idx].set(jnp.where(matched, 0, age[m_idx]))
    age = age.at[slots].set(jnp.where(ins_ok | boot_ok, 0, age[slots]))
    map_valid = map_valid & (age < 600)

    lost = (~first) & (n_match < 8) & (~reloc)

    # ---- backend world-registration events (VioConfig snap_* model) ----
    # Tracking stress arms the model; an armed frame fires a backend event
    # with probability snap_p_stressed; relocalization is a
    # re-registration by construction and always fires.  Stress =
    # sustained body rotation (pure rotation is ORB-SLAM3's worst case:
    # no translation parallax, motion blur, VI re-initialization) OR
    # match starvation / rejected frames.  An event snaps the
    # emitted-pose translation offset (std proportional to travel since
    # the last event — the accumulated local error a real backend
    # correction re-distributes) and re-estimates the reported scale
    # (reverting toward truth, as VI scale refinement does).
    rot_rate = jnp.linalg.norm(so3_log(
        quat_mul(quat_conj(state.q), q_new))) / jnp.maximum(dt_frame, 1e-3)
    # stress is ROTATIONAL only (plus relocalization below, which always
    # fires): tracking-failure frames (~enough) were originally a trigger
    # too, but our 256-feature observe() dips below the n_match>=8 bar on
    # dense-forest teach drives where the reference's 3000-feature ORB does
    # not — with (~enough) armed, teach drift on routes 05/06 ran 1.2-2.1 m
    # vs the reference band's 0.48-0.65 (r4 full campaign) while repeat
    # snaps are already carried by the rotation term (recovery spins at
    # 0.8-1.0 rad/s).  A genuine tracking collapse still snaps via reloc.
    stressed = (n_match < cfg.snap_stress_match_n) | \
        (rot_rate > cfg.snap_stress_rot)
    stress_streak = jnp.where(stressed & (~first),
                              state.stress_streak + 1, jnp.int32(0))
    # sustained match starvation (ADVICE r4 #4): a tracking collapse that
    # limps for seconds without achieving relocalization is a real
    # backend-correction scenario (ORB-SLAM3's VI estimator re-initializes
    # under it) — but our 256-feature observe() dips below short-streak
    # count thresholds on dense-forest teach frames where the reference's
    # 3000-feature ORB does not, so the streak requirement is LONG
    # (snap_starve_min frames ≈ seconds), unlike the 5-frame rotation
    # streak.  Teach-band parity is re-measured in the calibration
    # artifact whenever these change.
    starved = n_match < cfg.snap_starve_match_n
    starve_streak = jnp.where(starved & (~first),
                              state.starve_streak + 1, jnp.int32(0))
    dist_since = state.dist_since_event + jnp.where(
        enough, jnp.linalg.norm(pos_new - state.pos), 0.0)
    if key is not None and cfg.snap_p_stressed > 0.0:
        k_ev, k_scale, k_off = jax.random.split(key, 3)
        armed = ((stress_streak >= cfg.snap_stress_min) |
                 (starve_streak >= cfg.snap_starve_min)) & \
            (dist_since >= cfg.snap_min_dist_m)
        fire = (armed & (jax.random.uniform(k_ev) < cfg.snap_p_stressed)) \
            | reloc
        snap_std = jnp.minimum(cfg.snap_frac * dist_since, cfg.snap_cap_m)
        off_delta = snap_std * jax.random.normal(k_off, (3,)) * \
            jnp.array([1.0, 1.0, 0.2])
        emit_off = state.emit_off + jnp.where(fire, off_delta,
                                              jnp.zeros(3))
        scale_next = 1.0 + cfg.scale_revert * (state.emit_scale - 1.0) + \
            cfg.scale_jump_std * jax.random.normal(k_scale)
        emit_scale = jnp.where(fire, scale_next, state.emit_scale)
        dist_since = jnp.where(fire, 0.0, dist_since)
        stress_streak = jnp.where(fire, jnp.int32(0), stress_streak)
        starve_streak = jnp.where(fire, jnp.int32(0), starve_streak)
    else:
        fire = jnp.array(False)
        emit_off = state.emit_off
        emit_scale = state.emit_scale

    # --- keyframe push (every kf_min_disp of tracked motion) ---
    K = state.kf_pos.shape[0]
    kf_disp = jnp.linalg.norm(pos_new - state.last_kf_pos)
    push = enough & (kf_disp >= 0.5)
    slot_kf = state.kf_ptr % K
    # store the best-matched observations (matched first, by match order)
    m_order = jnp.argsort(~matched)[:KF_OBS]
    kf_pos = jnp.where(push, state.kf_pos.at[slot_kf].set(pos_new),
                       state.kf_pos)
    kf_quat = jnp.where(push, state.kf_quat.at[slot_kf].set(q_new),
                        state.kf_quat)
    kf_valid = jnp.where(push, state.kf_valid.at[slot_kf].set(True),
                         state.kf_valid)
    kf_obs_slot = jnp.where(
        push, state.kf_obs_slot.at[slot_kf].set(m_idx[m_order]),
        state.kf_obs_slot)
    kf_obs_uv = jnp.where(
        push, state.kf_obs_uv.at[slot_kf].set(obs.uv[m_order]),
        state.kf_obs_uv)
    kf_obs_z = jnp.where(
        push, state.kf_obs_z.at[slot_kf].set(obs.p3d_cam[m_order, 2]),
        state.kf_obs_z)
    kf_obs_valid = jnp.where(
        push, state.kf_obs_valid.at[slot_kf].set(matched[m_order]),
        state.kf_obs_valid)

    new_state = VioState(
        pos=pos_new, vel=vel_new, q=q_new,
        map_xyz=map_xyz, map_desc=map_desc, map_valid=map_valid,
        map_age=age, map_obs=map_obs,
        next_slot=(state.next_slot + n_ins.astype(jnp.int32)) % MAP_CAP,
        lost=lost, implaus_streak=implaus_streak,
        n_tracked=n_match.astype(jnp.int32),
        frames=state.frames + 1,
        kf_pos=kf_pos, kf_quat=kf_quat, kf_valid=kf_valid,
        kf_ptr=state.kf_ptr + jnp.where(push, 1, 0),
        kf_obs_slot=kf_obs_slot, kf_obs_uv=kf_obs_uv, kf_obs_z=kf_obs_z,
        kf_obs_valid=kf_obs_valid,
        last_kf_pos=jnp.where(push, pos_new, state.last_kf_pos),
        emit_scale=emit_scale, emit_off=emit_off,
        dist_since_event=dist_since, stress_streak=stress_streak,
        starve_streak=starve_streak)
    aux = VioAux(
        n_desc=n_desc.astype(jnp.int32),
        n_match=n_match.astype(jnp.int32),
        n_ins=n_ins.astype(jnp.int32),
        flags=(enough.astype(jnp.int32)
               | (finite.astype(jnp.int32) << 1)
               | (plausible.astype(jnp.int32) << 2)
               | (lost.astype(jnp.int32) << 3)
               | (reloc.astype(jnp.int32) << 4)
               | (fire.astype(jnp.int32) << 5)))
    return new_state, ~lost, aux


def emit_body_pos(state: VioState) -> jax.Array:
    """Body position as REPORTED at the SLAM pose interface: the internal
    estimate through the current world registration (scale about the init
    origin + offset).  This — not ``state.pos`` — is what drift monitors
    and the relay see, like the reference reading /tmp/slam_pose.txt."""
    return state.emit_scale * state.pos + state.emit_off


def emit_slam_pose(state: VioState, cam: CameraConfig):
    """VIO body pose -> ORB-SLAM3-convention camera pose (t, quat xyzw) in
    the first-camera world frame, as consumed by the fusion relay.  Goes
    through the world registration (emit_body_pos), so backend snap events
    appear at this interface exactly as they do in /tmp/slam_pose.txt."""
    from nclt_slam_tpu.fusion.relay import T_FLU_FROM_CAM

    R_wb = quat_to_mat(state.q)
    t_bc = jnp.array([cam.cam_offset_fwd, 0.0, cam.cam_offset_up])
    T_nav = jnp.eye(4).at[:3, :3].set(R_wb).at[:3, 3].set(
        emit_body_pos(state) + R_wb @ t_bc)
    T_slam = jnp.linalg.inv(T_FLU_FROM_CAM) @ T_nav @ T_FLU_FROM_CAM
    from nclt_slam_tpu.core.quat import mat_to_quat
    return T_slam[:3, 3], mat_to_quat(T_slam[:3, :3])


def local_ba(state: VioState, cam: CameraConfig, cfg: VioConfig) -> VioState:
    """Sliding-window local BA over the keyframe ring (ORB-SLAM3's
    local-mapping BA, run at a uniform cadence from the rollout).

    OFF by default (VioConfig.enable_local_ba) — measured to degrade the
    streaming estimator it feeds; see the config comment for the numbers.

    The window's landmark set is the newest keyframe's observed map slots;
    observation weights for older keyframes come from slot-id matching, so
    all shapes stay fixed.  Optimized poses update the keyframe ring and
    the current pose (by the newest keyframe's correction); optimized
    points write back to the map.
    """
    from nclt_slam_tpu.vio.ba import BAProblem, solve_ba

    K = state.kf_pos.shape[0]
    newest = (state.kf_ptr - 1) % K
    slots = state.kf_obs_slot[newest]                      # (P,) P = KF_OBS
    pts0 = state.map_xyz[slots]

    # (K, P) observation weights by slot-id equality against each KF's obs
    eq = state.kf_obs_slot[:, :, None] == slots[None, None, :]  # (K, S, P)
    pair_ok = eq & state.kf_obs_valid[:, :, None]
    obs_w = (pair_ok.any(1) & state.kf_valid[:, None]).astype(jnp.float32)
    src = jnp.argmax(pair_ok, axis=1)                      # (K, P) obs index
    obs_uv = jnp.take_along_axis(
        state.kf_obs_uv, src[..., None], axis=1)
    obs_z = jnp.take_along_axis(state.kf_obs_z, src, axis=1)

    # order the ring chronologically (oldest..newest) for the rel factors
    order = (state.kf_ptr + jnp.arange(K)) % K
    kf_pos = state.kf_pos[order]
    kf_quat = state.kf_quat[order]
    kf_ok = state.kf_valid[order]
    obs_w = obs_w[order] * kf_ok[:, None]
    obs_uv = obs_uv[order]
    obs_z = obs_z[order]

    # relative factors from the current estimates (regularizer holding the
    # window shape while reprojection refines it)
    dq = jax.vmap(lambda qi, qj: quat_mul(quat_conj(qi), qj))(
        kf_quat[:-1], kf_quat[1:])
    dp = jax.vmap(lambda qi, pi, pj: quat_to_mat(qi).T @ (pj - pi))(
        kf_quat[:-1], kf_pos[:-1], kf_pos[1:])

    # anchor each point at its running-mean estimate, weight ~ one pixel^2
    # residual per prior re-observation (capped: very old points stay
    # slightly adjustable)
    pt_prior = 0.5 * jnp.minimum(
        state.map_obs[slots], 100).astype(jnp.float32)
    prob = BAProblem(
        kf_pos=kf_pos, kf_quat=kf_quat, points=pts0,
        obs_uv=obs_uv, obs_z=obs_z, obs_w=obs_w,
        rel_dp=dp, rel_dq=dq, w_rel=jnp.float32(10.0),
        pt_prior_w=pt_prior)
    res = solve_ba(prob, cam, cfg, iters=3)

    finite = (jnp.isfinite(res.kf_pos).all() & jnp.isfinite(res.kf_quat).all()
              & jnp.isfinite(res.points).all())
    # Trust region instead of all-or-nothing rejection: a max-correction
    # gate of 0.5 m/1 m rejected essentially EVERY solve on live windows
    # (one outlier-corrupted point or a genuinely correctable 0.6 m pose
    # error vetoed the whole solution, leaving the BA permanently dormant).
    # ORB-SLAM3's g2o applies damped steps; we scale the window correction
    # so the largest keyframe move is <= ba_trust_m (direction-preserving)
    # and only discard a wildly diverged solve.
    TRUST_M = 0.5
    WILD_M = 5.0
    d_kf = jnp.linalg.norm(res.kf_pos - kf_pos, axis=-1).max()
    scale = jnp.minimum(1.0, TRUST_M / jnp.maximum(d_kf, 1e-6))
    ba_pos = kf_pos + scale * (res.kf_pos - kf_pos)
    drot = jax.vmap(lambda q0, q1: so3_log(quat_mul(quat_conj(q0), q1)))(
        kf_quat, res.kf_quat)
    ba_quat = jax.vmap(lambda q0, dr: quat_mul(q0, so3_exp(scale * dr)))(
        kf_quat, drot)
    ba_quat = ba_quat / jnp.linalg.norm(ba_quat, axis=-1, keepdims=True)
    enough = (obs_w.sum() >= 12) & (state.kf_valid.sum() >= 3) & finite \
        & (d_kf <= WILD_M) & (~state.lost)

    # write back: keyframes (undo the chronological reorder)
    inv = jnp.argsort(order)
    new_kf_pos = jnp.where(enough, ba_pos[inv], state.kf_pos)
    new_kf_quat = jnp.where(enough, ba_quat[inv], state.kf_quat)

    # The live pose is NOT composed with the BA delta: the newest KF is up
    # to kf_min_disp of travel stale, and left-composing its correction
    # onto a pose the per-frame GN has already re-estimated against the
    # live map injects stale noise (measured: raw VIO drift 0.09 -> 0.51 m
    # with composition, either trust-scaled or priored).  ORB-SLAM3's
    # local-mapping BA likewise never touches the tracker's pose directly —
    # the tracker benefits through the refined map/keyframes only.

    # map write-back: per-point gating (seen by >= 2 KFs, bounded move) —
    # an outlier-yanked landmark no longer vetoes its window-mates
    wb_pt = obs_w.sum(0) >= 2
    d_pt = jnp.linalg.norm(res.points - pts0, axis=-1)
    valid_pt = wb_pt & (d_pt <= 1.0)
    map_xyz = state.map_xyz.at[slots].set(
        jnp.where((valid_pt & enough)[:, None], res.points,
                  state.map_xyz[slots]))

    return state._replace(kf_pos=new_kf_pos, kf_quat=new_kf_quat,
                          map_xyz=map_xyz)

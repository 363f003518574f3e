"""Repeat-time visual anchor matcher (visual_landmark_matcher.py port).

2 Hz anchor attempts: pick teach landmarks within 8 m of the VIO pose with
heading within 90° (top-5 by distance), match descriptors with a mutual
cross-check, solve the relative camera pose teach->live with batched
RANSAC (vmapped 3-point Kabsch hypotheses scored by 2-D reprojection — the
batched equivalent of solvePnPRansac ITERATIVE/200it/3px), apply the
reference's gates (>= 10 matches, >= 10 inliers, median reproj <= 2 px),
compose the anchor pose through the teach camera's world pose, reject
anchors > 5 m from VIO, and map inlier count -> anchor std
(25 -> 0.05, 15 -> 0.2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nclt_slam_tpu.config import CameraConfig, LandmarkConfig
from nclt_slam_tpu.landmarks.store import LandmarkStore
from nclt_slam_tpu.sensors.features import Observation, cross_check_match


class AnchorResult(NamedTuple):
    xy: jnp.ndarray        # (2,) anchor base position (world)
    std: jnp.ndarray       # ()
    ok: jnp.ndarray        # () bool — published
    n_inliers: jnp.ndarray
    reproj: jnp.ndarray
    reason: jnp.ndarray    # () int32 outcome code (for anchor_matches.csv)


# outcome codes (anchor_matches.csv 'outcome' column equivalents)
R_PUBLISHED = 0
R_NO_CANDIDATES = 1
R_NO_FEATURES = 2
R_NO_PNP_ACCEPT = 3
R_CONSISTENCY_FAIL = 4


def _kabsch(P, Q, w):
    """Weighted rigid alignment R,t with R @ P + t ~= Q.
    P, Q (..., N, 3), w (..., N); leading batch dims supported and computed
    as one batched program over the 200-hypothesis RANSAC batch.

    Horn's quaternion method with power iteration instead of SVD: XLA lowers
    tiny SVDs to an iterative decomposition, slow when vmapped x1000 (RANSAC
    hypotheses); the 4x4 eigenvector via a fixed-count power iteration is
    pure fused arithmetic."""
    from nclt_slam_tpu.core.quat import quat_to_mat

    w = w[..., None]
    wsum = jnp.maximum(w.sum(-2, keepdims=True), 1e-6)
    mp = (P * w).sum(-2, keepdims=True) / wsum        # (..., 1, 3)
    mq = (Q * w).sum(-2, keepdims=True) / wsum
    H = jnp.einsum("...ni,...nj->...ij", (P - mp) * w, Q - mq)  # (..., 3, 3)

    # Horn's N matrix (quaternion order w, x, y, z), kept as a 4x4 python
    # grid of BATCH-shaped scalars: as (batch,) element-wise ops the 4x4
    # algebra is fully unrolled and the batch stays the minor axis, instead
    # of tiny size-4 minor dims on every power-iteration step.
    sxx, sxy, sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    syx, syy, syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    szx, szy, szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    # shift so the (possibly negative-spectrum) max eigenvalue dominates
    shift = 2.0 * jnp.sqrt((H * H).sum((-2, -1))) + 1e-6
    Nm = [
        [sxx + syy + szz + shift, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz + shift, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, -sxx + syy - szz + shift, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz + shift],
    ]

    # power iteration from all 4 basis starts (a single start can be nearly
    # orthogonal to the dominant eigenvector, e.g. ~180° rotations); pick
    # the result with the largest Rayleigh quotient
    one = jnp.ones_like(shift)
    V = [[one * (1.05 if i == k else 0.05) for k in range(4)]
         for i in range(4)]
    for _ in range(24):
        V2 = [[sum(Nm[i][j] * V[j][k] for j in range(4)) for k in range(4)]
              for i in range(4)]
        for k in range(4):
            nrm = jnp.sqrt(sum(V2[i][k] ** 2 for i in range(4))) + 1e-12
            for i in range(4):
                V[i][k] = V2[i][k] / nrm
    rayleigh = [
        sum(V[i][k] * Nm[i][j] * V[j][k] for i in range(4) for j in range(4))
        for k in range(4)]
    best = jnp.argmax(jnp.stack(rayleigh, -1), -1)
    v = [sum(jnp.where(best == k, V[i][k], 0.0) for k in range(4))
         for i in range(4)]
    q_xyzw = jnp.stack([v[1], v[2], v[3], v[0]], -1)
    R = quat_to_mat(q_xyzw)
    t = mq[..., 0, :] - jnp.einsum("...ij,...j->...i", R, mp[..., 0, :])
    return R, t


def _project(p_cam, cam: CameraConfig):
    z = jnp.maximum(p_cam[..., 2], 1e-6)
    u = cam.fx * p_cam[..., 0] / z + cam.cx
    v = cam.fy * p_cam[..., 1] / z + cam.cy
    return jnp.stack([u, v], -1)


def ransac_pose(p3d_teach, uv_live, p3d_live, pair_valid, key,
                cam: CameraConfig, cfg: LandmarkConfig):
    """RANSAC T_live_teach from matched (teach 3-D, live 2-D/3-D) pairs.

    Returns (R, t, n_inliers, median_reproj, ok)."""
    F = p3d_teach.shape[0]
    H = cfg.ransac_iterations

    # sample minimal sets from the compacted matched pool, not the raw slot
    # array (most slots are unmatched padding)
    pool = jnp.argsort(~pair_valid)          # matched indices first
    n_pairs = pair_valid.sum()
    j = jax.random.randint(key, (H, 3), 0, jnp.maximum(n_pairs, 1))
    idx = pool[j]
    distinct = (j[:, 0] != j[:, 1]) & (j[:, 1] != j[:, 2]) & \
               (j[:, 0] != j[:, 2])
    hyp_ok = distinct & (n_pairs >= 3)

    # one batched gather + one batched Horn solve over all H hypotheses
    Rs, ts = _kabsch(p3d_teach[idx], p3d_live[idx],
                     jnp.ones((H, 3)))                # (H,3,3), (H,3)

    # score by reprojection of ALL teach points into the live image
    pred = jnp.einsum("hij,fj->hfi", Rs, p3d_teach) + ts[:, None, :]
    uv_pred = _project(pred, cam)
    err = jnp.linalg.norm(uv_pred - uv_live[None], axis=-1)  # (H, F)
    inl = (err < cfg.ransac_reproj_px) & pair_valid[None, :]
    n_inl = jnp.where(hyp_ok, inl.sum(-1), -1)
    best = jnp.argmax(n_inl)

    # refine on the best hypothesis' inliers
    w = inl[best].astype(jnp.float32)
    R_ref, t_ref = _kabsch(p3d_teach, p3d_live, w)
    pred = p3d_teach @ R_ref.T + t_ref
    err = jnp.linalg.norm(_project(pred, cam) - uv_live, axis=-1)
    inl_f = (err < cfg.ransac_reproj_px) & pair_valid
    n_f = inl_f.sum()

    # median reprojection over final inliers
    err_sorted = jnp.sort(jnp.where(inl_f, err, jnp.inf))
    med = err_sorted[jnp.maximum((n_f - 1) // 2, 0)]

    ok = (n_f >= cfg.min_inliers) & (med <= cfg.reproj_max_px) & (n_inl[best] > 0)
    return R_ref, t_ref, n_f, med, ok


def sample_anchor_bias(lm_xy, key, cfg: LandmarkConfig):
    """Published-anchor error vector (LandmarkConfig.anchor_bias_*).

    Direction and the dominant magnitude component come from smooth
    world-position fields evaluated at the teach landmark's position
    (persistent per landmark, correlation length anchor_bias_scale_m);
    a small per-attempt lognormal/direction jitter sits on top.  The
    marginal magnitude over route positions is lognormal with median
    anchor_bias_median_m and p90 anchor_bias_p90_m; the gross-mismatch
    tail (anchor_gross_*) is i.i.d. per attempt — a wrong association
    that passed the PnP gates is an independent event, and its >5 m mass
    is what the consistency gate rejects (the CSV's 4.1 %
    consistency_fail rate).  Tail statistics are pinned in
    tests/test_landmarks.py::test_anchor_bias_tail_statistics."""
    from nclt_slam_tpu.sensors.features import _bias_field

    k_j, k_dj, k_g, k_gm = jax.random.split(key, 4)
    s = cfg.anchor_bias_scale_m
    fx = _bias_field(lm_xy[0], lm_xy[1], s, (0.7, 2.9, 4.1))
    fy = _bias_field(lm_xy[0], lm_xy[1], s, (1.9, 3.1, 5.9))
    fm = _bias_field(lm_xy[0], lm_xy[1], s, (2.3, 0.4, 3.7))
    # _bias_field marginal std over positions is ~0.707 (3 unit sines x
    # 0.577); split the target lognormal sigma between the field and the
    # per-attempt jitter so the combined p90/median ratio hits the CSV's
    sigma_tot = jnp.log(cfg.anchor_bias_p90_m / cfg.anchor_bias_median_m) \
        / 1.281552  # Phi^-1(0.90)
    sigma_f = jnp.sqrt(jnp.maximum(
        sigma_tot ** 2 - cfg.anchor_bias_jitter_ln ** 2, 0.0)) / 0.707
    mag = jnp.exp(jnp.log(cfg.anchor_bias_median_m) + sigma_f * fm +
                  cfg.anchor_bias_jitter_ln * jax.random.normal(k_j))
    if cfg.anchor_gross_p > 0.0:
        gross = jax.random.uniform(k_g) < cfg.anchor_gross_p
        gmag = jnp.exp(jax.random.uniform(
            k_gm, minval=jnp.log(cfg.anchor_gross_lo_m),
            maxval=jnp.log(cfg.anchor_gross_hi_m)))
        mag = jnp.where(gross, gmag, mag)
    th = jnp.arctan2(fy, fx) + \
        cfg.anchor_bias_dir_jitter * jax.random.normal(k_dj)
    return mag * jnp.stack([jnp.cos(th), jnp.sin(th)])


def _block_dead(li, off, cfg: LandmarkConfig):
    """Cross-session appearance death per along-route landmark block.

    Landmarks are stored in along-route order (the 2 m displacement
    trigger), so blocks of ``dead_block_landmarks`` consecutive slots are
    ~12 m stretches of route whose views die together (sun-angle/shadow
    flips wipe a neighborhood's ORB responses wholesale — the mechanism
    behind the reference's bimodal anchor outcomes: failed attempts carry
    best_n_inliers ~0 while published ones average 31.8,
    anchor_matches.csv).  Block death follows a golden-ratio
    low-discrepancy sequence, so EVERY route's dead fraction sits within
    ~1 block of session_dead_frac (three-distance theorem) — unlike
    world-keyed cells, which a path samples unevenly (the r4/r5a 1.2-86 %
    per-route publish pathology; see LandmarkConfig.session_dead_frac).
    ``off`` is the per-route session phase."""
    block = li // jnp.maximum(cfg.dead_block_landmarks, 1)
    u = jnp.mod(block.astype(jnp.float32) * 0.6180339887 + off, 1.0)
    return u < cfg.session_dead_frac


def match_tick(store: LandmarkStore, obs: Observation, vio_xy, vio_heading,
               base_pos_vio, key, cam: CameraConfig,
               cfg: LandmarkConfig,
               consistency_extra_m=0.0) -> AnchorResult:
    """One 2 Hz anchor attempt.

    ``consistency_extra_m`` widens the anchor-vs-nav consistency gate —
    the caller scales it with anchor drought so a long-uncorrected drift
    cannot permanently reject every (correct) anchor (the death spiral the
    reference's exp-58 dormant-landmark accumulator chased,
    visual_landmark_matcher.py:78-89)."""
    L = cfg.max_landmarks
    lm_valid = jnp.arange(L) < store.count

    # candidate gate: distance < 8 m AND heading within 90° (matcher:291-302)
    d = jnp.linalg.norm(store.cam_pos[:, :2] - vio_xy[None, :], axis=-1)
    hdg_err = jnp.abs(jnp.arctan2(jnp.sin(store.cam_yaw - vio_heading),
                                  jnp.cos(store.cam_yaw - vio_heading)))
    cand = lm_valid & (d < cfg.candidate_radius_m) & \
        (hdg_err < jnp.deg2rad(cfg.heading_tol_deg))
    d_masked = jnp.where(cand, d, jnp.inf)
    top = jnp.argsort(d_masked)[: cfg.max_candidates]
    top_ok = jnp.isfinite(d_masked[top])
    any_cand = jnp.any(top_ok)

    live_valid = obs.valid
    enough_live = live_valid.sum() >= cfg.min_matches

    # per-route session phase for the block-death sequence: keyed on the
    # route's first recorded landmark (constant through the session)
    sess_off = jnp.mod(store.cam_pos[0, 0] * 0.7548777 +
                       store.cam_pos[0, 1] * 0.5698403, 1.0)

    keys = jax.random.split(key, cfg.max_candidates)

    def try_candidate(li, li_ok, k):
        t_desc = store.desc[li]
        t_valid = store.feat_valid[li]
        m_idx, matched = cross_check_match(t_desc, t_valid, obs.desc, live_valid)
        dead = _block_dead(li, sess_off, cfg)
        matched = matched & ~dead       # dead view: nothing cross-matches
        n_match = matched.sum()
        enough = n_match >= cfg.min_matches

        p3d_t = store.p3d_cam[li]
        uv_l = obs.uv[m_idx]
        p3d_l = obs.p3d_cam[m_idx]
        R, t, n_inl, med, pnp_ok = ransac_pose(
            p3d_t, uv_l, p3d_l, matched, k, cam, cfg)

        # compose: teach-cam world pose ∘ (T_live_teach)^-1 -> live cam world
        # (matcher:361-378, with yaw-only camera world poses)
        cyaw = store.cam_yaw[li]
        c, s = jnp.cos(cyaw), jnp.sin(cyaw)
        # world_from_teachcam rotation (FLU yaw ∘ base->cam axes)
        from nclt_slam_tpu.sensors.depth import R_BASE_CAM
        R_w_t = jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ R_BASE_CAM
        # live cam pose in teach cam frame: inverse of T_live_teach
        R_t_l = R.T
        t_t_l = -R.T @ t
        cam_world = store.cam_pos[li] + R_w_t @ t_t_l
        ok = li_ok & enough & pnp_ok
        return ok, n_inl, med, cam_world

    oks, n_inls, meds, cam_worlds = jax.vmap(try_candidate)(top, top_ok, keys)
    score = jnp.where(oks, n_inls, -1)
    best = jnp.argmax(score)
    best_ok = oks[best] & enough_live

    cam_world = cam_worlds[best]
    # camera world -> base world (reverse the forward camera offset)
    # heading from VIO (anchor orientation is taken loosely; the relay only
    # consumes x, y — v55 uses encoder yaw)
    bx = cam_world[0] - cam.cam_offset_fwd * jnp.cos(vio_heading)
    by = cam_world[1] - cam.cam_offset_fwd * jnp.sin(vio_heading)
    anchor_xy = jnp.stack([bx, by])

    # aliased-correspondence bias on the composed anchor (see
    # LandmarkConfig.anchor_bias_*): a persistent, spatially-correlated
    # error field evaluated at the matched teach landmark — repeated
    # matches to the same landmark repeat the same error, and consecutive
    # landmarks along the route carry nearly the same error.  Applied
    # before the consistency gate so the model's >5 m tail produces the
    # CSV's consistency_fail rate naturally.
    if cfg.anchor_bias_median_m > 0.0:
        lm_xy = store.cam_pos[top[best], :2]
        anchor_xy = anchor_xy + sample_anchor_bias(
            lm_xy, jax.random.fold_in(key, 7), cfg)

    # consistency gate vs VIO (5 m base, drought-widened by the caller)
    cons_d = jnp.linalg.norm(anchor_xy - vio_xy)
    consistent = cons_d <= cfg.consistency_m + consistency_extra_m
    published = best_ok & consistent

    # covariance model (matcher:399-410)
    n_inl = n_inls[best]
    std = jnp.where(
        n_inl >= cfg.inlier_hi, cfg.std_good,
        jnp.where(n_inl >= cfg.inlier_lo,
                  cfg.std_good + 0.15 * (cfg.inlier_hi - n_inl) / 10.0,
                  cfg.std_bad))

    reason = jnp.where(published, R_PUBLISHED,
                       jnp.where(~enough_live, R_NO_FEATURES,
                                 jnp.where(~any_cand, R_NO_CANDIDATES,
                                           jnp.where(best_ok, R_CONSISTENCY_FAIL,
                                                     R_NO_PNP_ACCEPT))))
    return AnchorResult(xy=anchor_xy, std=std, ok=published,
                        n_inliers=n_inl, reproj=meds[best], reason=reason)

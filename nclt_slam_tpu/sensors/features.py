"""Feature observation model — the framework's ORB replacement.

The reference extracts ORB keypoints from rendered RGB (recorder 500 feats,
matcher 500, VIO 3000).  We have no photoreal renderer; instead the scene
itself carries persistent visual landmarks: every collider exposes a ring of
surface feature points, each with a fixed 256-bit binary descriptor derived
deterministically from (collider id, feature id).  An observation projects
the visible points through the pinhole camera, applies occlusion and
image-bound gates, and flips a few random descriptor bits — so descriptor
matching, false-match statistics, and PnP behave like the real pipeline
without rasterizing images (SURVEY.md hard part #3).

All shapes are fixed: the scene exposes S = N_colliders x FEATS_PER_OBJ
world points; an observation returns the best ``max_obs`` by pixel validity.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from nclt_slam_tpu.config import CameraConfig, LandmarkConfig
from nclt_slam_tpu.sensors.depth import camera_pose

FEATS_PER_OBJ = 24  # 1/4 on the trunk, 3/4 on the ground apron around it
# (12 starved the anchor funnel: stored 44 / live 109 / mutual ~11 ->
#  inliers pinned ~16 vs the CSV's 31.8; real ORB frames carry ~1000
#  corners and the recorder stores 500 — r3 calibration)
_TRUNK_FEATS = 6    # features on the collider wall; the rest are apron


class SceneFeatures(NamedTuple):
    xyz: jnp.ndarray     # (S, 3) world feature points
    desc: jnp.ndarray    # (S, desc_words) uint32 descriptors
    owner: jnp.ndarray   # (S,) collider index
    valid: jnp.ndarray   # (S,)
    pkeep: jnp.ndarray   # (S,) per-tick keep probability (clutter dropout)
    view_thr: jnp.ndarray    # (S, 32*desc_words) uint8 per-bit angular
    #                          thresholds (continuous viewpoint decorrelation)
    view_alpha: jnp.ndarray  # (S,) per-feature anchor azimuth [rad]


GROUND_DENSITY = 0.6  # forest-floor texture features per m^2


def build_scene_features(obs_xy: np.ndarray, obs_r: np.ndarray,
                         obs_base_z: np.ndarray, obs_h: np.ndarray,
                         obs_valid: np.ndarray, cfg: LandmarkConfig,
                         seed: int = 123,
                         ground_density: float = GROUND_DENSITY,
                         bounds=None) -> SceneFeatures:
    """Deterministic surface feature points + descriptors (numpy, offline).

    Besides the per-collider trunk/apron rings, a uniform forest-floor
    texture field (roots, grass tufts, leaf litter — what real ORB latches
    onto everywhere in the reference's forest) covers the scene bounds with
    ``ground_density`` points/m^2 so the observation never starves between
    tree clusters.  Ground features carry owner=-1: they never disappear
    with obstacle removal."""
    rng = np.random.RandomState(seed)
    N = len(obs_xy)
    S = N * FEATS_PER_OBJ
    owner = np.repeat(np.arange(N, dtype=np.int32), FEATS_PER_OBJ)
    valid = np.repeat(np.asarray(obs_valid, bool), FEATS_PER_OBJ)
    half = _TRUNK_FEATS
    # One block draw reproducing the original per-feature loop's RNG stream
    # exactly (uniform(a,b) = a + (b-a)*random_sample in numpy): per
    # collider the draw order is [ang, frac] x half then [ang, rad, zj] x
    # (FEATS_PER_OBJ - half).  The scalar double-loop version of this took
    # seconds per call x 30 pack_scene calls per campaign build.
    n_ap = FEATS_PER_OBJ - half
    draws = rng.random_sample((N, 2 * half + 3 * n_ap))
    tr = draws[:, : 2 * half].reshape(N, half, 2)
    ap = draws[:, 2 * half:].reshape(N, n_ap, 3)
    oxy = np.asarray(obs_xy, np.float64)
    orad = np.asarray(obs_r, np.float64)
    # trunk/surface features on the collider wall
    ang_t = 2.0 * np.pi * tr[:, :, 0]
    frac = 0.15 + (0.9 - 0.15) * tr[:, :, 1]
    t_xyz = np.stack([
        oxy[:, None, 0] + orad[:, None] * np.cos(ang_t),
        oxy[:, None, 1] + orad[:, None] * np.sin(ang_t),
        obs_base_z[:, None] + frac * np.maximum(obs_h, 0.3)[:, None],
    ], -1)
    # ground-texture features (roots, grass, debris) on the apron around
    # the collider — these are what survives the recorder's below-horizon
    # gate, like real forest-floor ORB
    ang_a = 2.0 * np.pi * ap[:, :, 0]
    rad = orad[:, None] + (0.3 + (2.0 - 0.3) * ap[:, :, 1])
    a_xyz = np.stack([
        oxy[:, None, 0] + rad * np.cos(ang_a),
        oxy[:, None, 1] + rad * np.sin(ang_a),
        obs_base_z[:, None] + 0.02 + (0.15 - 0.02) * ap[:, :, 2],
    ], -1)
    xyz = np.concatenate([t_xyz, a_xyz], 1).reshape(S, 3).astype(np.float32)
    if ground_density > 0:
        act = np.asarray(obs_valid, bool)
        ref_xy = obs_xy[act] if act.any() else np.zeros((1, 2))
        if bounds is None:
            bounds = (ref_xy[:, 0].min() - 15, ref_xy[:, 0].max() + 15,
                      ref_xy[:, 1].min() - 15, ref_xy[:, 1].max() + 15)
        x0, x1, y0, y1 = bounds
        G = int((x1 - x0) * (y1 - y0) * ground_density)
        gx = rng.uniform(x0, x1, G).astype(np.float32)
        gy = rng.uniform(y0, y1, G).astype(np.float32)
        from nclt_slam_tpu.scene.terrain import terrain_height

        gz = np.asarray(terrain_height(gx, gy)) + \
            rng.uniform(0.02, 0.12, G).astype(np.float32)
        xyz = np.concatenate([xyz, np.stack([gx, gy, gz], -1)], 0)
        owner = np.concatenate([owner, np.full(G, -1, np.int32)], 0)
        valid = np.concatenate([valid, np.ones(G, bool)], 0)
        S += G

    # --- descriptors: texture-class codebook + per-feature unique bits ---
    # (see LandmarkConfig.desc_classes for the aliasing rationale)
    if cfg.desc_classes > 0:
        protos = rng.randint(0, 2 ** 32, size=(cfg.desc_classes, cfg.desc_words),
                             dtype=np.uint64).astype(np.uint32)
        # colliders draw a class each (nearby trees share texture classes at
        # random); every ground feature draws its own class
        coll_class = rng.randint(0, cfg.desc_classes, size=max(N, 1))
        feat_class = np.where(owner >= 0, coll_class[np.maximum(owner, 0)],
                              rng.randint(0, cfg.desc_classes, size=S))
        p_u = min(cfg.desc_unique_bits / (32.0 * cfg.desc_words), 0.5)
        u_bits = (rng.random_sample((S, cfg.desc_words, 32)) < p_u)
        weights = (1 << np.arange(32, dtype=np.uint64))
        u_mask = (u_bits * weights[None, None, :]).sum(-1).astype(np.uint32)
        desc = protos[feat_class] ^ u_mask
    else:
        desc = rng.randint(0, 2 ** 32, size=(S, cfg.desc_words),
                           dtype=np.uint64).astype(np.uint32)

    # --- clutter-scaled per-tick keep probability ---
    # count valid colliders within clutter_radius_m of each feature; dense
    # clusters (deep forest) occlude and shadow their features more often
    act = np.asarray(obs_valid, bool)
    if act.any():
        # KDTree ball counts instead of the dense (S, N) distance matrix:
        # at walled-scene scale that matrix is ~10^8 float64 (GBs of
        # intermediates) and dominated campaign build time
        from scipy.spatial import cKDTree
        cxy = np.asarray(obs_xy, np.float32)[act]
        tree = cKDTree(np.asarray(cxy, np.float64))
        clutter = tree.query_ball_point(
            np.asarray(xyz[:, :2], np.float64), cfg.clutter_radius_m,
            return_length=True)
    else:
        clutter = np.zeros(S)
    excess = np.maximum(clutter - cfg.clutter_free_trees, 0)
    pkeep = np.clip((1.0 - cfg.feat_dropout)
                    * (1.0 - cfg.clutter_drop_per_tree * excess),
                    cfg.feat_pkeep_min, 1.0).astype(np.float32)

    # --- continuous viewpoint decorrelation (LandmarkConfig.view_bits_per_deg)
    # Per-bit random angular thresholds: the flip mask at azimuth az is
    # {bits : thr < g(Δ(az, alpha))}, nested in Δ, so two observations
    # differ by ~view_bits_per_deg * Δazimuth bits, saturating at 128.
    nbits = 32 * cfg.desc_words
    view_thr = rng.randint(0, 256, size=(S, nbits), dtype=np.uint8)
    view_alpha = rng.uniform(-np.pi, np.pi, S).astype(np.float32)

    return SceneFeatures(
        xyz=jnp.asarray(xyz), desc=jnp.asarray(desc),
        owner=jnp.asarray(owner), valid=jnp.asarray(valid),
        pkeep=jnp.asarray(pkeep), view_thr=jnp.asarray(view_thr),
        view_alpha=jnp.asarray(view_alpha))


class Observation(NamedTuple):
    """Fixed-size feature observation from one camera pose."""

    uv: jnp.ndarray        # (K, 2) pixel coords
    p3d_cam: jnp.ndarray   # (K, 3) points in the OpenCV camera frame
    desc: jnp.ndarray      # (K, words) noisy descriptors
    feat_id: jnp.ndarray   # (K,) index into SceneFeatures
    valid: jnp.ndarray     # (K,)


def observe(base_pos, yaw, feats: SceneFeatures, obs_valid_now,
            key, cam: CameraConfig, cfg: LandmarkConfig,
            yaw_rate=0.0, occluders=None,
            px_session_amp: float = 0.0) -> Observation:
    """Project scene features through the camera; gate, occlude, and corrupt.

    obs_valid_now: (N_colliders,) current collider validity (drops may have
    been removed) — features of removed colliders disappear.
    yaw_rate: commanded |ω| this tick — drives the rotational motion-blur
    degradation (CameraConfig.blur_drop_per_radps).
    occluders: optional (xy (M, 2), radius (M,), base_z (M,), height (M,),
    active (M,)) cylinders that geometrically block the line of sight —
    the repeat pass feeds the route's dropped obstacles here (cone walls /
    prop clusters standing between the camera and the teach-time scene,
    spawn_obstacles.py), which is what makes the obstacle corridor degrade
    both the repeat VIO and the anchor matcher in the reference.  Teach
    passes no occluders (drops absent).
    """
    blur = jnp.abs(jnp.float32(yaw_rate))
    origin, R_wc = camera_pose(base_pos, yaw, cam)
    rel = feats.xyz - origin[None, :]
    p_cam = rel @ R_wc  # world->cam: R^T @ rel, row-vec form

    z = p_cam[:, 2]
    u = cam.fx * p_cam[:, 0] / jnp.maximum(z, 1e-6) + cam.cx
    v = cam.fy * p_cam[:, 1] / jnp.maximum(z, 1e-6) + cam.cy
    dist = jnp.linalg.norm(p_cam, axis=-1)

    in_img = (u >= 1) & (u < cam.width - 1) & (v >= 1) & (v < cam.height - 1)
    in_depth = (z > cam.depth_min) & (z < cam.depth_max)
    # owner -1 = ground-texture feature, never removed with obstacles
    alive = feats.valid & ((feats.owner < 0)
                           | obs_valid_now[jnp.maximum(feats.owner, 0)])
    # clutter-scaled per-tick dropout (motion blur / occlusion / shadow):
    # the spatially-varying starvation that makes dense-forest stretches
    # genuinely hard for the VIO, like the reference's ORB texture deserts
    k_drop, key = jax.random.split(key)
    # rotational motion blur scales the keep probability down with |ω|
    pkeep = jnp.maximum(
        feats.pkeep * (1.0 - cam.blur_drop_per_radps * blur),
        cam.blur_pkeep_floor)
    kept = jax.random.bernoulli(k_drop, pkeep)
    vis = in_img & in_depth & alive & kept

    # Occlusion is handled statistically by the descriptor-noise model (a
    # geometric per-feature occlusion test against all colliders would cost
    # S x N ray tests per observation; the matcher's inlier gates absorb the
    # difference).  Back-face features do survive here — they act as the
    # false-match population the RANSAC gates are tuned against.

    # selection: keep the max_obs nearest visible features (deterministic);
    # pad with invalid slots when the scene has fewer features than the cap.
    # top_k instead of a full argsort: S is ~14k once the ground-texture
    # field is in and this runs every tick on every route.
    score = jnp.where(vis, dist, jnp.inf)
    K = cfg.max_obs_features
    S = score.shape[0]
    if S >= K:
        neg, idx = jax.lax.top_k(-score, K)
        sel_valid = jnp.isfinite(neg)
    else:
        order = jnp.argsort(score)
        idx = jnp.concatenate([order, jnp.zeros(K - S, order.dtype)])
        sel_valid = jnp.concatenate(
            [jnp.isfinite(score[order]), jnp.zeros(K - S, bool)])

    # geometric line-of-sight occlusion by novel obstacles: a feature whose
    # camera ray passes through an active occluder cylinder (below its top)
    # is blocked.  Runs on the K selected features only (K x M tests).
    if occluders is not None:
        oxy, orad, oz0, oh, oact, oidx = occluders
        sel_xyz = feats.xyz[idx]                      # (K, 3)
        d2d = sel_xyz[:, :2] - origin[None, :2]       # (K, 2)
        L2 = jnp.maximum((d2d ** 2).sum(-1), 1e-6)    # (K,)
        mo = oxy - origin[None, :2]                   # (M, 2)
        t = (mo[None, :, :] * d2d[:, None, :]).sum(-1) / L2[:, None]  # (K, M)
        between = (t > 0.05) & (t < 0.95)
        closest = t[..., None] * d2d[:, None, :]      # (K, M, 2) from cam
        gap2 = ((closest - mo[None]) ** 2).sum(-1)    # (K, M)
        ray_z = origin[2] + t * (sel_xyz[:, 2:3] - origin[2])
        blocked = (between & (gap2 < (orad ** 2)[None]) & oact[None]
                   & (ray_z < (oz0 + oh)[None])
                   & (feats.owner[idx][:, None] != oidx[None])).any(-1)
        sel_valid = sel_valid & ~blocked

    # observation noise: pixel jitter + depth noise + descriptor bit flips
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    uv = jnp.stack([u[idx], v[idx]], -1)
    # surviving corners localize worse under blur (smeared gradients)
    px_sigma = cam.px_noise * (1.0 + cam.px_blur_per_radps * blur)
    uv = uv + px_sigma * jax.random.normal(k1, uv.shape)
    # correlated systematic pointing bias (see CameraConfig.px_bias_amp):
    # locally constant, so it does NOT average away across features — the
    # error source that actually accumulates into VIO drift
    if cam.px_bias_amp > 0:
        ub = _bias_field(origin[0], origin[1], cam.px_bias_scale_m,
                         (0.3, 2.1, 4.4))
        vb = _bias_field(origin[0], origin[1], cam.px_bias_scale_m,
                         (1.7, 3.9, 5.6))
        uv = uv + cam.px_bias_amp * jnp.stack([ub, vb])[None, :]
    # repeat-session pointing bias: changed lighting/shadows between the
    # teach recording and the repeat drive move the apparent corner
    # positions systematically (a different-session ORB localizes the same
    # physical corner 1-2 px away).  Separate phases from the per-session
    # calibration field above; teach passes px_session_amp=0, so this is
    # the error source that makes the repeat VIO drift harder than the
    # teach VIO at equal speed — the reference's repeat-vs-teach drift
    # asymmetry (routes/README.md:24-40 vs :132-151).
    if px_session_amp > 0:
        us = _bias_field(origin[0], origin[1], cam.px_bias_scale_m,
                         (5.2, 1.1, 3.3))
        vs = _bias_field(origin[0], origin[1], cam.px_bias_scale_m,
                         (0.9, 4.7, 2.4))
        uv = uv + px_session_amp * jnp.stack([us, vs])[None, :]
    p3d = p_cam[idx]
    # stereo-depth error: sigma_z/z = depth_noise_rel_per_m * z (quadratic
    # absolute error, like D435i disparity-limited depth)
    rel_std = cam.depth_noise_rel_per_m * jnp.maximum(p3d[:, 2:3], 0.0)
    depth_noise = 1.0 + rel_std * jax.random.normal(k2, (K, 1))
    p3d = p3d * depth_noise  # multiplicative range noise
    # correlated depth-scale bias (stereo-baseline thermal drift analog)
    if cam.depth_bias_amp > 0:
        db = _bias_field(origin[0], origin[1], cam.depth_bias_scale_m,
                         (2.6, 0.8, 5.1))
        p3d = p3d * (1.0 + cam.depth_bias_amp * db)
    # gross depth outliers: stereo mismatch on repetitive bark / specular
    # foliage throws a few % of depths far off the surface
    if cam.depth_outlier_frac > 0:
        is_out = jax.random.bernoulli(k4, cam.depth_outlier_frac, (K, 1))
        out_scale = jax.random.uniform(
            k5, (K, 1), minval=cam.depth_outlier_lo,
            maxval=cam.depth_outlier_hi)
        p3d = jnp.where(is_out, p3d * out_scale, p3d)

    desc = feats.desc[idx]
    # continuous viewpoint corruption: flip every bit whose angular
    # threshold lies below this view's distance from the feature's anchor
    # azimuth — nested masks, so |flips between two views| grows at
    # ~view_bits_per_deg per degree of viewpoint change (the ORB
    # viewpoint cliff the anchor matcher pays; consecutive VIO frames
    # see sub-degree deltas and pay nothing)
    if cfg.view_bits_per_deg > 0:
        rel_f = origin[None, :2] - feats.xyz[idx, :2]
        az = jnp.arctan2(rel_f[:, 1], rel_f[:, 0])
        dal = jnp.abs(jnp.mod(az - feats.view_alpha[idx] + jnp.pi,
                              2.0 * jnp.pi) - jnp.pi)          # (K,) [0, pi]
        # mask fraction g in [0, 0.5]: bits_per_deg rate, saturating at
        # 128 bits (≈ random) by 128/view_bits_per_deg degrees
        g = 0.5 * jnp.minimum(
            jnp.degrees(dal) * cfg.view_bits_per_deg / 128.0, 1.0)
        thr = feats.view_thr[idx].astype(jnp.float32) / 255.0  # (K, 256)
        flips = (thr < g[:, None] - 1e-7)
        W = cfg.desc_words
        fw = flips.reshape(K, W, 32).astype(jnp.uint32)
        bitw = (2 ** jnp.arange(32, dtype=jnp.uint32))
        desc = desc ^ (fw * bitw[None, None, :]).sum(-1).astype(jnp.uint32)
    # flip ~desc_noise_bits random bits: for each word, build a mask with
    # desc_noise_bits/256 per-bit probability
    p_flip = cfg.desc_noise_bits / (32.0 * cfg.desc_words)
    flip_bits = jax.random.bernoulli(
        k3, p_flip, (K, cfg.desc_words, 32)).astype(jnp.uint32)
    weights = (2 ** jnp.arange(32, dtype=jnp.uint32))
    flip_mask = (flip_bits * weights[None, None, :]).sum(-1).astype(jnp.uint32)
    desc = desc ^ flip_mask

    return Observation(uv=uv, p3d_cam=p3d, desc=desc,
                       feat_id=idx.astype(jnp.int32),
                       valid=sel_valid)


def resample_session(feats: SceneFeatures, cfg, seed: int) -> SceneFeatures:
    """Cross-session detector resample (LandmarkConfig.session_overlap).

    Keeps each feature with probability ``session_overlap``; the rest are
    replaced by DIFFERENT physical corners — position jittered on the same
    surface, fresh descriptor/viewpoint state — so a teach-time landmark
    snapshot only partially exists in the repeat world.  Host-side numpy,
    runs once at scene-pack time."""
    p = float(cfg.session_overlap)
    if p >= 1.0:
        return feats
    xyz = np.asarray(feats.xyz).copy()
    desc = np.asarray(feats.desc).copy()
    thr = np.asarray(feats.view_thr).copy()
    alpha = np.asarray(feats.view_alpha).copy()
    S, W = desc.shape
    rng = np.random.RandomState((seed * 31 + 17) & 0x7FFFFFFF)
    replace = rng.random_sample(S) >= p
    n = int(replace.sum())
    if n == 0:
        return feats
    # a different corner nearby: up to ~0.5 m vertically on the trunk /
    # ~0.3 m laterally on the ground patch
    xyz[replace] += np.column_stack([
        rng.normal(0, 0.15, n), rng.normal(0, 0.15, n),
        rng.normal(0, 0.35, n)]).astype(np.float32)
    weights = (1 << np.arange(32, dtype=np.uint64))
    p_flip = 0.5  # a different physical point: descriptor uncorrelated
    flips = (rng.random_sample((n, W, 32)) < p_flip)
    desc[replace] ^= (flips * weights[None, None, :]).sum(-1).astype(np.uint32)
    thr[replace] = rng.randint(0, 256, size=(n, thr.shape[1]), dtype=np.uint8)
    alpha[replace] = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return feats._replace(xyz=jnp.asarray(xyz), desc=jnp.asarray(desc),
                          view_thr=jnp.asarray(thr),
                          view_alpha=jnp.asarray(alpha))


def session_shift_masks(shape, bits, seed: int) -> np.ndarray:
    """Fixed per-feature XOR masks with ~``bits`` set bits out of 32*W —
    the cross-session appearance gap (LandmarkConfig.session_shift_bits).
    ``bits`` may be a scalar or a per-feature (S,) array (the per-collider
    appearance-death model passes bimodal values).
    Host-side numpy: runs once at scene-pack time."""
    S, W = shape
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    p = np.minimum(np.asarray(bits, np.float64) / (32.0 * W), 0.5)
    p = np.broadcast_to(p, (S,))[:, None, None]
    bits_arr = rng.random_sample((S, W, 32)) < p
    weights = (1 << np.arange(32, dtype=np.uint64))
    return (bits_arr * weights[None, None, :]).sum(-1).astype(np.uint32)


def _bias_field(x, y, scale, phases):
    """Smooth ~unit-variance scalar field: three incommensurate plane
    waves of wavelength ``scale``.  Deterministic — it plays the role of a
    fixed (but spatially varying) sensor calibration state."""
    k = 2.0 * jnp.pi / scale
    t1 = jnp.sin(k * (0.93 * x + 0.36 * y) + phases[0])
    t2 = jnp.sin(k * (-0.41 * x + 0.91 * y) + phases[1])
    t3 = jnp.sin(k * (0.55 * x - 0.83 * y) + phases[2])
    return (t1 + t2 + t3) * 0.577


def hamming(d1, d2):
    """Pairwise Hamming distance between descriptor sets.

    d1 (A, W) uint32, d2 (B, W) uint32 -> (A, B) int32.
    """
    x = d1[:, None, :] ^ d2[None, :, :]
    return jax.lax.population_count(x).sum(-1).astype(jnp.int32)


CROSS_CHECK_BIG = 10 ** 6   # distance given to pairs with an invalid side


def cross_check_match_reference(desc_a, valid_a, desc_b, valid_b,
                                max_dist: int = 64):
    """Host numpy brute force of ``cross_check_match`` (bit-unpacking
    popcount, explicit loops over A for the mutual check): the plain
    reference the device matcher must equal exactly.  Returns
    (best_ab, matched, best_d) as numpy arrays."""
    da = np.asarray(desc_a, np.uint32)
    db = np.asarray(desc_b, np.uint32)
    x = da[:, None, :] ^ db[None, :, :]
    h = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int64)
    ok = np.asarray(valid_a, bool)[:, None] & np.asarray(valid_b, bool)[None]
    h = np.where(ok, h, CROSS_CHECK_BIG)
    best_ab = h.argmin(axis=1)
    best_ba = h.argmin(axis=0)
    best_d = h[np.arange(len(da)), best_ab]
    matched = np.array([best_ba[best_ab[a]] == a for a in range(len(da))],
                       bool) & (best_d <= max_dist)
    return best_ab, matched, best_d


def cross_check_match(desc_a, valid_a, desc_b, valid_b, max_dist: int = 64,
                      return_dist: bool = False):
    """BFMatcher(crossCheck=True) equivalent: mutual nearest neighbors under
    a Hamming cap.  Returns (match_idx (A,), matched (A,)) mapping a->b;
    with ``return_dist`` also the per-a best distance (novelty gate).

    XLA fuses the xor, the popcount (one instruction per word on a GPU), the
    word sum and both argmins; ties resolve to the lowest index."""
    h = hamming(desc_a, desc_b)
    big = jnp.int32(CROSS_CHECK_BIG)
    h = jnp.where(valid_a[:, None] & valid_b[None, :], h, big)
    best_ab = jnp.argmin(h, axis=1)                  # (A,)
    best_ba = jnp.argmin(h, axis=0)                  # (B,)
    a_idx = jnp.arange(h.shape[0])
    mutual = best_ba[best_ab] == a_idx
    best_d = h[a_idx, best_ab]
    dist_ok = best_d <= max_dist
    if return_dist:
        return best_ab, mutual & dist_ok, best_d
    return best_ab, mutual & dist_ok

"""Global registration for loop-closure candidates: FPFH + RANSAC + ICP.

Capability match for the reference's Open3D-backed global registration
(datasets/nclt/src/slam/loop_closure.py:15-207: FPFH features + RANSAC
feature matching + ICP refinement before accepting a loop edge).  The
batched shape: normals from dense k-NN covariance eigenvectors, a
simplified FPFH (Darboux-angle histograms over the k-NN graph, SPFH +
neighbor-weighted sum like Rusu et al.), feature correspondences as one
dense descriptor-distance matmul, and Kabsch over vmapped 3-point RANSAC
hypotheses — all fixed-shape, no trees or dynamic neighbor lists.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nclt_slam_tpu.datasets.slam.icp import _kabsch_weighted, icp_point_to_point

FPFH_BINS = 11          # bins per Darboux angle -> 33-dim descriptor
K_NEIGHBORS = 16


def _knn(pts, valid, k: int):
    """Dense k-NN: (N, k) neighbor indices + validity (self excluded)."""
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    big = jnp.float32(1e12)
    d2 = jnp.where(valid[None, :], d2, big)
    d2 = d2 + jnp.eye(pts.shape[0]) * big          # exclude self
    idx = jnp.argsort(d2, axis=1)[:, :k]
    nd2 = jnp.take_along_axis(d2, idx, axis=1)
    ok = nd2 < big / 2
    return idx, ok


def estimate_normals(pts, valid, k: int = K_NEIGHBORS):
    """Per-point normal = smallest-eigenvector of the k-NN covariance."""
    idx, ok = _knn(pts, valid, k)
    nb = pts[idx]                                   # (N, k, 3)
    w = ok.astype(jnp.float32)[..., None]
    cnt = jnp.maximum(w.sum(1), 1.0)
    mean = (nb * w).sum(1) / cnt
    d = (nb - mean[:, None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", d, d) / cnt[..., None]
    # eigh returns ascending eigenvalues: normal = first eigenvector
    _, vecs = jnp.linalg.eigh(cov + 1e-9 * jnp.eye(3))
    n = vecs[:, :, 0]
    # orient towards the sensor origin (reference uses viewpoint orientation)
    flip = (n * pts).sum(-1) > 0
    return jnp.where(flip[:, None], -n, n)


def _spfh(pts, normals, idx, ok):
    """Simplified point feature histogram per point: histograms of the
    Darboux angles (alpha, phi, theta) between each point and its k-NN."""
    N, k = idx.shape
    p = pts[:, None, :]                              # (N, 1, 3)
    q = pts[idx]                                     # (N, k, 3)
    n_p = normals[:, None, :]
    n_q = normals[idx]

    d = q - p
    dist = jnp.linalg.norm(d, axis=-1, keepdims=True)
    u = n_p
    d_hat = d / jnp.maximum(dist, 1e-9)
    v = jnp.cross(d_hat, jnp.broadcast_to(u, d_hat.shape))
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    w = jnp.cross(jnp.broadcast_to(u, v.shape), v)

    alpha = (v * n_q).sum(-1)                        # [-1, 1]
    phi = (u * d_hat).sum(-1)                        # [-1, 1]
    theta = jnp.arctan2((w * n_q).sum(-1), (u * n_q).sum(-1))  # [-pi, pi]

    def hist(x, lo, hi):
        bins = jnp.floor((x - lo) / (hi - lo) * FPFH_BINS)
        bins = jnp.clip(bins, 0, FPFH_BINS - 1).astype(jnp.int32)
        onehot = jax.nn.one_hot(bins, FPFH_BINS) * ok[..., None]
        return onehot.sum(1)                         # (N, FPFH_BINS)

    h = jnp.concatenate([
        hist(alpha, -1.0, 1.0),
        hist(phi, -1.0, 1.0),
        hist(theta, -jnp.pi, jnp.pi),
    ], -1)                                           # (N, 33)
    return h / jnp.maximum(h.sum(-1, keepdims=True), 1e-9)


def fpfh(pts, valid, k: int = K_NEIGHBORS):
    """FPFH descriptor (N, 33): SPFH + distance-weighted neighbor SPFH."""
    idx, ok = _knn(pts, valid, k)
    normals = estimate_normals(pts, valid, k)
    s = _spfh(pts, normals, idx, ok)
    d = jnp.linalg.norm(pts[idx] - pts[:, None, :], axis=-1)
    w = ok.astype(jnp.float32) / jnp.maximum(d, 0.05)
    nb = (s[idx] * w[..., None]).sum(1) / jnp.maximum(
        w.sum(1, keepdims=True), 1e-9)
    f = s + nb
    return f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-9)


class RegistrationResult(NamedTuple):
    R: jax.Array          # (3, 3)
    t: jax.Array          # (3,)
    n_inliers: jax.Array  # () int32 RANSAC consensus
    rmse: jax.Array       # () refined ICP rmse
    ok: jax.Array         # () bool — consensus above threshold


def ransac_registration(src, src_valid, dst, dst_valid, key,
                        k: int = K_NEIGHBORS, iters: int = 256,
                        inlier_thresh: float = 0.75,
                        min_inlier_frac: float = 0.25):
    """FPFH-correspondence RANSAC: dense feature NN src->dst, vmapped
    3-point Kabsch hypotheses, consensus on correspondence distance."""
    f_src = fpfh(src, src_valid, k)
    f_dst = fpfh(dst, dst_valid, k)

    # feature correspondences (one matmul: cosine distance)
    sim = f_src @ f_dst.T
    sim = jnp.where(src_valid[:, None] & dst_valid[None, :], sim, -1e9)
    corr = jnp.argmax(sim, axis=1)                   # (N,) src -> dst
    corr_ok = src_valid & (jnp.take_along_axis(
        sim, corr[:, None], axis=1)[:, 0] > -1e8)
    Q = dst[corr]

    N = src.shape[0]
    picks = jax.random.randint(key, (iters, 3), 0, N)

    def hypothesis(pick):
        P3, Q3 = src[pick], Q[pick]
        w3 = corr_ok[pick].astype(jnp.float32)
        R, t = _kabsch_weighted(P3, Q3, w3 + 1e-3)
        moved = src @ R.T + t
        resid = jnp.linalg.norm(moved - Q, axis=-1)
        inl = (resid < inlier_thresh) & corr_ok
        return R, t, inl.sum()

    Rs, ts, counts = jax.vmap(hypothesis)(picks)
    best = jnp.argmax(counts)
    n_inl = counts[best]
    ok = n_inl >= jnp.maximum(
        (min_inlier_frac * corr_ok.sum()).astype(jnp.int32), 10)
    return Rs[best], ts[best], n_inl, ok


def register_loop(src, src_valid, dst, dst_valid, key,
                  ransac_iters: int = 256, icp_iters: int = 20,
                  max_corr: float = 1.0,
                  fitness_min: float = 0.55) -> RegistrationResult:
    """Loop-candidate registration: FPFH-RANSAC global alignment, then
    point-to-point ICP refinement (loop_closure.py's
    global-registration-then-ICP chain).

    Acceptance follows Open3D's evaluate_registration: the refined ICP's
    FITNESS (fraction of valid src points with a correspondence within
    max_corr) and rmse — not the raw RANSAC consensus alone.  FPFH is
    near-degenerate on repetitive geometry (a forest of near-identical
    trunks gives every surface point the same descriptor), so the
    reference chain's RANSAC also passes largely-arbitrary correspondence
    sets there and lets the ICP verdict decide."""
    R0, t0, n_inl, ok = ransac_registration(
        src, src_valid, dst, dst_valid, key, iters=ransac_iters)
    res = icp_point_to_point(src, src_valid, dst, dst_valid,
                             R0=R0, t0=t0, iters=icp_iters,
                             max_corr=max_corr)
    fitness = res.n_inliers.astype(jnp.float32) / jnp.maximum(
        src_valid.sum().astype(jnp.float32), 1.0)
    accept = (ok | (fitness >= fitness_min)) & \
        (res.rmse < 0.6 * max_corr)
    return RegistrationResult(R=res.R, t=res.t, n_inliers=n_inl,
                              rmse=res.rmse, ok=accept)

"""LiDAR ICP odometry in JAX — the Open3D-ICP replacement.

Capability match for datasets/nclt/src/slam/icp_odometry.py +
imu_fusion.py's odometry-aided variant: point-to-point and point-to-plane
ICP with fixed iteration counts and brute-force nearest neighbors (dense
distance matrices — the batched choice for the reference's ~4k-point
downsampled scans), wheel-odometry prediction as the initial guess, a
sliding voxel local map, and RANSAC ground removal.  Everything is fixed-
shape and vmappable over scan pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ICPResult(NamedTuple):
    R: jax.Array          # (3, 3)
    t: jax.Array          # (3,)
    rmse: jax.Array       # () inlier RMSE
    n_inliers: jax.Array  # ()


def _nearest(src, dst, dst_valid):
    """Brute-force NN: for each src point the nearest dst point.

    src (N, 3), dst (M, 3) -> (idx (N,), dist (N,)).  Dense (N, M) distance
    matrix = one big matmul-shaped op, a good fit for <=8k points.
    """
    d2 = ((src[:, None, :] - dst[None, :, :]) ** 2).sum(-1)
    d2 = jnp.where(dst_valid[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=1)
    return idx, jnp.sqrt(d2[jnp.arange(src.shape[0]), idx])


def _kabsch_weighted(P, Q, w):
    wsum = jnp.maximum(w.sum(), 1e-6)
    mp = (P * w[:, None]).sum(0) / wsum
    mq = (Q * w[:, None]).sum(0) / wsum
    H = ((P - mp) * w[:, None]).T @ (Q - mq)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]).at[2].set(d))
    R = Vt.T @ D @ U.T
    return R, mq - R @ mp


def icp_point_to_point(src, src_valid, dst, dst_valid, R0=None, t0=None,
                       iters: int = 20, max_corr: float = 1.0) -> ICPResult:
    """Point-to-point ICP src->dst with fixed iterations.

    src/dst: (N, 3)/(M, 3) padded arrays with validity masks.
    R0/t0: initial guess (e.g. wheel-odometry prediction)."""
    R0 = jnp.eye(3) if R0 is None else R0
    t0 = jnp.zeros(3) if t0 is None else t0

    def body(carry, _):
        R, t = carry
        moved = src @ R.T + t
        idx, dist = _nearest(moved, dst, dst_valid)
        w = (src_valid & (dist < max_corr)).astype(jnp.float32)
        R2, t2 = _kabsch_weighted(src, dst[idx], w)
        return (R2, t2), (dist, w)

    (R, t), (dists, ws) = jax.lax.scan(body, (R0, t0), None, length=iters)
    last_d, last_w = dists[-1], ws[-1]
    n_inl = last_w.sum()
    rmse = jnp.sqrt((last_w * last_d ** 2).sum() / jnp.maximum(n_inl, 1.0))
    return ICPResult(R=R, t=t, rmse=rmse, n_inliers=n_inl.astype(jnp.int32))


def icp_point_to_plane(src, src_valid, dst, dst_normals, dst_valid,
                       R0=None, t0=None, iters: int = 15,
                       max_corr: float = 1.0) -> ICPResult:
    """Point-to-plane ICP via small-angle linearization (6x6 solve/iter)."""
    R0 = jnp.eye(3) if R0 is None else R0
    t0 = jnp.zeros(3) if t0 is None else t0

    def body(carry, _):
        R, t = carry
        moved = src @ R.T + t
        idx, dist = _nearest(moved, dst, dst_valid)
        q = dst[idx]
        n = dst_normals[idx]
        w = (src_valid & (dist < max_corr)).astype(jnp.float32)
        r = ((moved - q) * n).sum(-1)                    # (N,)
        J = jnp.concatenate([jnp.cross(moved, n), n], -1)  # (N, 6)
        Jw = J * w[:, None]
        H = Jw.T @ J + 1e-6 * jnp.eye(6)
        g = Jw.T @ r
        dx = -jnp.linalg.solve(H, g)
        dR = _rodrigues(dx[:3])
        return (dR @ R, dR @ t + dx[3:]), (dist, w)

    (R, t), (dists, ws) = jax.lax.scan(body, (R0, t0), None, length=iters)
    last_d, last_w = dists[-1], ws[-1]
    n_inl = last_w.sum()
    rmse = jnp.sqrt((last_w * last_d ** 2).sum() / jnp.maximum(n_inl, 1.0))
    return ICPResult(R=R, t=t, rmse=rmse, n_inliers=n_inl.astype(jnp.int32))


def _rodrigues(w):
    th = jnp.linalg.norm(w) + 1e-12
    k = w / th
    K = jnp.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return jnp.eye(3) + jnp.sin(th) * K + (1 - jnp.cos(th)) * (K @ K)


def remove_ground_ransac(pts, valid, key, iters: int = 64,
                         dist_thresh: float = 0.25):
    """RANSAC plane fit + removal (imu_fusion.remove_ground equivalent).

    Fits the dominant near-horizontal plane over ``iters`` vmapped 3-point
    hypotheses; returns validity mask with ground points removed."""
    N = pts.shape[0]
    idx = jax.random.randint(key, (iters, 3), 0, N)

    def plane(ix):
        p0, p1, p2 = pts[ix[0]], pts[ix[1]], pts[ix[2]]
        n = jnp.cross(p1 - p0, p2 - p0)
        n = n / (jnp.linalg.norm(n) + 1e-9)
        return n, (n * p0).sum()

    ns, ds = jax.vmap(plane)(idx)
    # distance of every point to every plane: (iters, N)
    dist = jnp.abs(pts @ ns.T - ds[None, :]).T
    inl = (dist < dist_thresh) & valid[None, :]
    # prefer near-horizontal planes (|nz| large)
    score = inl.sum(-1) * (jnp.abs(ns[:, 2]) > 0.8)
    best = jnp.argmax(score)
    ground = inl[best]
    return valid & ~ground, ns[best], ds[best]


class LocalMap(NamedTuple):
    """Sliding local map of the last S downsampled scans
    (imu_fusion.LocalMap: 20-scan window)."""

    pts: jax.Array      # (S, N, 3) scans in world frame
    valid: jax.Array    # (S, N)
    cursor: jax.Array   # () int32


def init_local_map(n_scans: int, pts_per_scan: int) -> LocalMap:
    return LocalMap(pts=jnp.zeros((n_scans, pts_per_scan, 3)),
                    valid=jnp.zeros((n_scans, pts_per_scan), bool),
                    cursor=jnp.int32(0))


def local_map_insert(m: LocalMap, scan_world, scan_valid) -> LocalMap:
    slot = m.cursor % m.pts.shape[0]
    return LocalMap(pts=m.pts.at[slot].set(scan_world),
                    valid=m.valid.at[slot].set(scan_valid),
                    cursor=m.cursor + 1)


def local_map_flat(m: LocalMap):
    S, N, _ = m.pts.shape
    return m.pts.reshape(S * N, 3), m.valid.reshape(S * N)

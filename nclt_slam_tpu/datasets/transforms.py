"""Composable point-cloud transforms — the augmentation pipeline for the
place-recognition / dataset stack.

Capability match for the reference's
``datasets/nclt_kaggle/src/datasets/transforms.py:1-195`` (Compose,
RandomRotation, RandomFlip, RandomJitter, RandomSubsample, VoxelDownsample,
Normalize, RemoveGround, build_transforms), redesigned for jit:

- every transform is a PURE function ``(key, points, mask) -> (points, mask)``
  with an explicit RNG key (no hidden ``np.random`` state), so pipelines jit,
  vmap over batches, and reproduce exactly;
- shapes are STATIC: "subsample" and "remove ground" mask points out instead
  of shrinking N (XLA needs fixed shapes; consumers weight by ``mask``);
- ``compose`` chains transforms, splitting the key per stage;
- ``build_transforms`` mirrors the reference's config-dict factory keys.

``points`` is (N, C) with xyz in the first 3 columns (extra columns — e.g.
intensity — pass through untouched, like the reference).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "random_rotation", "random_flip", "random_jitter", "random_subsample",
    "voxel_downsample", "normalize", "remove_ground", "compose",
    "build_transforms", "apply_batch",
]


def _with_xyz(points, xyz):
    return points.at[:, :3].set(xyz) if points.shape[1] > 3 else xyz


def random_rotation(key, points, mask, max_angle_deg: float = 180.0):
    """Random rotation about +Z (transforms.py RandomRotation)."""
    ang = jnp.deg2rad(jax.random.uniform(
        key, (), minval=-max_angle_deg, maxval=max_angle_deg))
    c, s = jnp.cos(ang), jnp.sin(ang)
    R = jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return _with_xyz(points, points[:, :3] @ R.T), mask


def random_flip(key, points, mask, prob: float = 0.5):
    """Random X and/or Y mirror (transforms.py RandomFlip)."""
    kx, ky = jax.random.split(key)
    sx = jnp.where(jax.random.bernoulli(kx, prob), -1.0, 1.0)
    sy = jnp.where(jax.random.bernoulli(ky, prob), -1.0, 1.0)
    xyz = points[:, :3] * jnp.array([1.0, 1.0, 1.0]).at[0].set(sx).at[1].set(sy)
    return _with_xyz(points, xyz), mask


def random_jitter(key, points, mask, sigma: float = 0.01, clip: float = 0.05):
    """Clipped Gaussian per-point noise (transforms.py RandomJitter)."""
    noise = jnp.clip(sigma * jax.random.normal(key, points[:, :3].shape),
                     -clip, clip)
    return _with_xyz(points, points[:, :3] + noise), mask


def random_subsample(key, points, mask, num_points: int = 4096):
    """Keep a random ``num_points``-subset of the live points, as a mask
    update (transforms.py RandomSubsample — static-shape form)."""
    n_live = mask.sum()
    # rank live points by random score; keep the num_points smallest ranks
    score = jax.random.uniform(key, mask.shape)
    score = jnp.where(mask, score, jnp.inf)
    order = jnp.argsort(score)
    rank = jnp.zeros_like(order).at[order].set(jnp.arange(order.shape[0]))
    keep = (rank < num_points) & mask
    del n_live
    return points, keep


_VOXEL_HASH = 1 << 18


def voxel_downsample(key, points, mask, voxel_size: float = 0.1):
    """Keep one point per occupied voxel (transforms.py VoxelDownsample).

    Static-shape form: voxel ids hash into a 2^18 table and a scatter-min
    elects one surviving point per slot.  Hash collisions drop a point
    spuriously (~N/2^18 odds) — harmless for augmentation and documented
    here so nobody relies on exact parity with Open3D voxelization."""
    del key
    v = jnp.floor(points[:, :3] / voxel_size).astype(jnp.int32)
    h = (v[:, 0] * 73856093 ^ v[:, 1] * 19349663 ^ v[:, 2] * 83492791) \
        % _VOXEL_HASH
    idx = jnp.arange(mask.shape[0], dtype=jnp.int32)
    table = jnp.full(_VOXEL_HASH, jnp.iinfo(jnp.int32).max, jnp.int32)
    table = table.at[h].min(jnp.where(mask, idx, jnp.iinfo(jnp.int32).max))
    keep = (table[h] == idx) & mask
    return points, keep


def normalize(key, points, mask, center: bool = True, scale: bool = False):
    """Center (and optionally unit-scale) the live points
    (transforms.py Normalize)."""
    del key
    w = mask.astype(points.dtype)[:, None]
    n = jnp.maximum(w.sum(), 1.0)
    xyz = points[:, :3]
    if center:
        xyz = xyz - (xyz * w).sum(0) / n
    if scale:
        r = jnp.sqrt(((xyz ** 2).sum(-1) * w[:, 0]).max())
        xyz = xyz / jnp.maximum(r, 1e-6)
    return _with_xyz(points, xyz), mask


def remove_ground(key, points, mask, threshold: float = -1.5):
    """Mask out points below a z threshold (transforms.py RemoveGround —
    NCLT's body frame is z-down, hence the negative default)."""
    del key
    return points, mask & (points[:, 2] > threshold)


def compose(*stages):
    """Chain ``(key, points, mask) -> (points, mask)`` stages, splitting the
    key per stage (the reference's Compose)."""

    def run(key, points, mask):
        keys = jax.random.split(key, max(len(stages), 1))
        for k, stage in zip(keys, stages):
            points, mask = stage(k, points, mask)
        return points, mask

    return run


def build_transforms(config: dict, is_train: bool = True):
    """Config-dict factory with the reference's keys
    (transforms.py build_transforms:169-195)."""
    pc = config.get("point_cloud", {})
    aug = config.get("augmentation", {})
    stages = []
    if pc.get("remove_ground", False):
        stages.append(partial(remove_ground,
                              threshold=pc.get("ground_threshold", -1.5)))
    if pc.get("voxel_size"):
        stages.append(partial(voxel_downsample, voxel_size=pc["voxel_size"]))
    if is_train:
        if aug.get("random_rotation", False):
            stages.append(partial(random_rotation,
                                  max_angle_deg=aug.get("rotation_range",
                                                        180.0)))
        if aug.get("random_flip", False):
            stages.append(random_flip)
        if aug.get("jitter"):
            stages.append(partial(random_jitter, sigma=aug["jitter"]))
    stages.append(partial(random_subsample,
                          num_points=pc.get("max_points", 4096)))
    return compose(*stages)


def apply_batch(pipeline, key, points, mask):
    """vmap a pipeline over a batch: points (B, N, C), mask (B, N)."""
    keys = jax.random.split(key, points.shape[0])
    return jax.vmap(pipeline)(keys, points, mask)

"""Tests: composable point-cloud transforms + ROVER prep tools.

Mirrors the reference's TestTransforms coverage
(datasets/nclt_kaggle/tests/test_dataset.py / test_models.py:127-193) on
the static-shape pipeline, plus the RGB-D association and
fisheye rectification math of the ROVER scripts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nclt_slam_tpu.datasets.transforms import (
    apply_batch,
    build_transforms,
    compose,
    normalize,
    random_flip,
    random_jitter,
    random_rotation,
    random_subsample,
    remove_ground,
    voxel_downsample,
)
from nclt_slam_tpu.io.rover import (
    associate_rgbd,
    fisheye_rectify_maps,
    remap_bilinear,
)


@pytest.fixture
def cloud():
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.uniform(-10, 10, (512, 4)).astype(np.float32))
    return pts, jnp.ones(512, bool)


def test_rotation_preserves_radii_and_z(cloud):
    pts, mask = cloud
    out, m = random_rotation(jax.random.PRNGKey(1), pts, mask)
    np.testing.assert_allclose(np.hypot(out[:, 0], out[:, 1]),
                               np.hypot(pts[:, 0], pts[:, 1]), rtol=1e-5)
    np.testing.assert_allclose(out[:, 2], pts[:, 2])
    np.testing.assert_allclose(out[:, 3], pts[:, 3])  # extra channel intact
    assert bool((m == mask).all())


def test_jitter_clipped(cloud):
    pts, mask = cloud
    out, _ = random_jitter(jax.random.PRNGKey(2), pts, mask,
                           sigma=0.5, clip=0.05)
    assert float(jnp.abs(out[:, :3] - pts[:, :3]).max()) <= 0.05 + 1e-6


def test_flip_is_axis_mirror(cloud):
    pts, mask = cloud
    out, _ = random_flip(jax.random.PRNGKey(0), pts, mask, prob=1.0)
    np.testing.assert_allclose(out[:, 0], -pts[:, 0])
    np.testing.assert_allclose(out[:, 1], -pts[:, 1])


def test_subsample_mask_count(cloud):
    pts, mask = cloud
    _, m = random_subsample(jax.random.PRNGKey(3), pts, mask, num_points=100)
    assert int(m.sum()) == 100


def test_voxel_downsample_density(cloud):
    pts, mask = cloud
    _, m = voxel_downsample(jax.random.PRNGKey(0), pts, mask, voxel_size=5.0)
    # 20 m cube at 5 m voxels -> at most 4^3 + boundary cells survive
    assert int(m.sum()) <= 130
    assert int(m.sum()) >= 8


def test_normalize_centers_live_points(cloud):
    pts, mask = cloud
    mask = mask.at[256:].set(False)
    out, _ = normalize(jax.random.PRNGKey(0), pts, mask)
    w = np.asarray(mask, np.float32)
    centroid = (np.asarray(out[:, :3]) * w[:, None]).sum(0) / w.sum()
    np.testing.assert_allclose(centroid, 0.0, atol=1e-4)


def test_remove_ground_masks_below(cloud):
    pts, mask = cloud
    _, m = remove_ground(jax.random.PRNGKey(0), pts, mask, threshold=0.0)
    assert bool((np.asarray(pts[np.asarray(m), 2]) > 0.0).all())


def test_build_transforms_and_batch_jit(cloud):
    pts, mask = cloud
    pipe = build_transforms({
        "point_cloud": {"remove_ground": True, "ground_threshold": -9.0,
                        "voxel_size": 0.5, "max_points": 64},
        "augmentation": {"random_rotation": True, "rotation_range": 45.0,
                         "random_flip": True, "jitter": 0.01},
    })
    batch_pts = jnp.stack([pts, pts + 1.0])
    batch_mask = jnp.stack([mask, mask])
    out, m = jax.jit(lambda k, p, ma: apply_batch(pipe, k, p, ma))(
        jax.random.PRNGKey(7), batch_pts, batch_mask)
    assert out.shape == batch_pts.shape
    assert int(m[0].sum()) == 64 and int(m[1].sum()) == 64


def test_compose_splits_keys(cloud):
    pts, mask = cloud
    pipe = compose(random_rotation, random_jitter)
    a, _ = pipe(jax.random.PRNGKey(0), pts, mask)
    b, _ = pipe(jax.random.PRNGKey(0), pts, mask)
    c, _ = pipe(jax.random.PRNGKey(1), pts, mask)
    np.testing.assert_allclose(a, b)          # deterministic in the key
    assert not np.allclose(a, c)              # and actually random


# ---- ROVER tools ----

def test_associate_rgbd_pairs_and_gates():
    rgb_t = np.array([0.00, 0.10, 0.20, 0.30, 0.40])
    depth_t = np.array([0.001, 0.102, 0.27, 0.401])  # one gap at 0.20/0.30
    ri, di = associate_rgbd(rgb_t, depth_t, max_diff_s=0.005)
    got = {(int(a), int(b)) for a, b in zip(ri, di)}
    assert got == {(0, 0), (1, 1), (4, 3)}
    # injectivity: a single depth frame can serve only one rgb frame
    ri2, di2 = associate_rgbd(np.array([0.0, 0.004]), np.array([0.002]),
                              max_diff_s=0.01)
    assert len(ri2) == 1 and len(di2) == 1


def test_fisheye_rectification_roundtrip():
    # zero-distortion fisheye reduces to equidistant projection; verify
    # the map is exact against the closed form at the principal point and
    # that remap recovers a smooth gradient image
    K = np.array([[285.0, 0, 320.0], [0, 285.0, 240.0], [0, 0, 1.0]])
    Knew = np.array([[200.0, 0, 160.0], [0, 200.0, 120.0], [0, 0, 1.0]])
    mx, my = fisheye_rectify_maps(K, [0, 0, 0, 0], Knew, (320, 240))
    assert mx.shape == (240, 320)
    # principal point maps to principal point
    np.testing.assert_allclose(mx[120, 160], 320.0, atol=1e-3)
    np.testing.assert_allclose(my[120, 160], 240.0, atol=1e-3)
    # remap a horizontal gradient: output must stay monotone along x
    img = np.tile(np.arange(640, dtype=np.float32), (480, 1))
    out = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(mx),
                                    jnp.asarray(my)))
    row = out[120]
    assert (np.diff(row[40:-40]) >= -1e-3).all()


def test_fisheye_distortion_bends_inward():
    # positive k1 pulls peripheral rays toward the center vs the
    # zero-distortion map (equidistant baseline)
    K = np.array([[285.0, 0, 320.0], [0, 285.0, 240.0], [0, 0, 1.0]])
    Knew = K.copy()
    mx0, _ = fisheye_rectify_maps(K, [0, 0, 0, 0], Knew, (640, 480))
    mx1, _ = fisheye_rectify_maps(K, [0.1, 0, 0, 0], Knew, (640, 480))
    # at the right edge, distorted map samples FURTHER out than undistorted
    assert mx1[240, 620] > mx0[240, 620] + 1.0

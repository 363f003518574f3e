"""Native C++ artefact runtime vs Python fallbacks (exact agreement)."""

import numpy as np
import pytest

from nclt_slam_tpu.io import native


@pytest.fixture(scope="module", autouse=True)
def require_native():
    assert native.have_native(), "g++ build of native/artefact_io.cpp failed"


def test_pgm_roundtrip_and_cross_path():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (95, 123), dtype=np.uint8)
    data = native.pgm_encode(img)
    back = native.pgm_decode(data)
    assert np.array_equal(back, img)
    # cross-check vs the io.artifacts loader
    import tempfile

    from nclt_slam_tpu.io.artifacts import load_teach_map, save_teach_map

    with tempfile.TemporaryDirectory() as d:
        tri = rng.randint(0, 3, (40, 60)).astype(np.int8)
        from nclt_slam_tpu.config import DEFAULT

        save_teach_map(tri, d + "/m", DEFAULT.map)
        raw = open(d + "/m.pgm", "rb").read()
        img2 = native.pgm_decode(raw)
        assert img2.shape == (40, 60)


def test_pgm_decode_rejects_garbage():
    with pytest.raises(ValueError):
        native.pgm_decode(b"JUNKDATA")


def test_velodyne_native_matches_python():
    from nclt_slam_tpu.datasets.loaders import save_velodyne_bin

    rng = np.random.RandomState(1)
    xyz = rng.uniform(-80, 80, (500, 3)).astype(np.float32)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = save_velodyne_bin(d + "/s.bin", xyz, rng.randint(0, 255, 500))
        raw = open(p, "rb").read()
    x_nat, i_nat = native.velodyne_unpack(raw)
    # force the python fallback
    lib, native._lib, native._build_failed = native._lib, None, True
    x_py, i_py = native.velodyne_unpack(raw)
    native._lib, native._build_failed = lib, False
    # 1-ulp f32 rounding-order differences between g++ and numpy
    assert np.allclose(x_nat, x_py, atol=2e-5)
    assert np.array_equal(i_nat, i_py)


def test_bresenham_native_matches_python():
    rng = np.random.RandomState(2)
    rows, cols = 64, 80
    r1s = rng.randint(0, rows, 40)
    c1s = rng.randint(0, cols, 40)
    g_nat = np.zeros((rows, cols), np.float32)
    native.bresenham_update(g_nat, 32, 40, r1s, c1s)
    lib, native._lib, native._build_failed = native._lib, None, True
    g_py = np.zeros((rows, cols), np.float32)
    native.bresenham_update(g_py, 32, 40, r1s, c1s)
    native._lib, native._build_failed = lib, False
    assert np.allclose(g_nat, g_py, atol=1e-6)
    assert (g_nat > 0).sum() > 0  # endpoints marked occupied
    assert (g_nat < 0).sum() > 40  # free cells cleared


def test_csv_parser_matches_python():
    text = ("ts,x,y\n" + "\n".join(
        f"{i * 0.1:.3f},{i * 2.0:.2f},{-i:.1f}" for i in range(50))).encode()
    a = native.csv_parse_floats(text, 3)
    lib, native._lib, native._build_failed = native._lib, None, True
    b = native.csv_parse_floats(text, 3)
    native._lib, native._build_failed = lib, False
    assert a.shape == (50, 3)
    assert np.allclose(a, b)


def test_jax_mapper_agrees_with_native_bresenham():
    """The scatter-based JAX occupancy update must agree with the native
    reference-exact Bresenham where it counts: endpoint cells occupied and
    the ray corridor cleared (the two formulations differ in per-cell free
    evidence, not in structure)."""
    import dataclasses

    import jax.numpy as jnp

    from nclt_slam_tpu.config import DEFAULT
    from nclt_slam_tpu.mapping.occupancy import (
        integrate_depth,
        occupancy_trinary,
        world_to_cell,
    )

    cfg = dataclasses.replace(DEFAULT.map, resolution=0.2, width_m=20.0,
                              height_m=20.0, origin_x=-10.0, origin_y=-10.0,
                              point_subsample=1)
    cam = np.array([0.0, 0.0], np.float32)
    # endpoints in a fan ahead, at obstacle height
    rng = np.random.RandomState(3)
    ang = rng.uniform(-0.6, 0.6, 24)
    dist = rng.uniform(3.0, 8.0, 24)
    from nclt_slam_tpu.scene.terrain import terrain_height

    px = dist * np.cos(ang)
    py = dist * np.sin(ang)
    ground = np.asarray(terrain_height(px, py))
    pts = np.stack([px, py, ground + 0.8], -1).astype(np.float32)

    grid = jnp.zeros((cfg.rows, cfg.cols), jnp.float32)
    for _ in range(4):  # several frames of evidence
        grid = integrate_depth(grid, jnp.asarray(cam), jnp.asarray(pts),
                               jnp.ones(len(pts), bool), cfg)
    tri = np.asarray(occupancy_trinary(grid, cfg))

    # native golden: Bresenham from the camera cell to each endpoint cell
    from nclt_slam_tpu.io.native import bresenham_update

    g_ref = np.zeros((cfg.rows, cfg.cols), np.float32)
    r0, c0 = world_to_cell(cam[0], cam[1], cfg)
    r1 = ((pts[:, 1] - cfg.origin_y) / cfg.resolution).astype(np.int32)
    c1 = ((pts[:, 0] - cfg.origin_x) / cfg.resolution).astype(np.int32)
    for _ in range(4):
        bresenham_update(g_ref, int(r0), int(c0), r1, c1)

    occ_ref = g_ref > np.log(0.65 / 0.35)
    # every reference-occupied endpoint cell is occupied in the JAX map
    assert (tri[occ_ref] == 2).mean() > 0.95
    # the cleared corridor is free/known in the JAX map too
    free_ref = g_ref < np.log(0.25 / 0.75)
    assert (tri[free_ref] != 2).mean() > 0.98

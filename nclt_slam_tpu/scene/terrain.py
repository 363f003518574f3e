"""Analytic forest terrain heightfield.

The reference scene's terrain is a closed-form multi-octave sine field with a
flattened S-curve road corridor (run_husky_forest.py:521-536 and
convert_gazebo_to_isaac.py:173-196 — the two must match, and ours matches
both).  Because it is analytic we never store a heightfield: the dynamics
step and the depth raycaster just evaluate ``terrain_height(x, y)`` — every
query is pure vectorized math with no memory traffic.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Road centreline waypoints (the S-curve the scene is built around);
# piecewise-linear y(x).  Same polyline as the reference scene model.
ROAD_WPS = np.array(
    [
        (-100, -7), (-95, -6), (-90, -4.5), (-85, -2.8), (-80, -1.5),
        (-75, -0.8), (-70, -0.5), (-65, -1), (-60, -2.2), (-55, -3.8),
        (-50, -5), (-45, -5.5), (-40, -5.2), (-35, -4), (-30, -2.5),
        (-25, -1), (-20, 0.2), (-15, 1.2), (-10, 1.8), (-5, 2), (0, 1.5),
        (5, 0.5), (10, -0.8), (15, -2.2), (20, -3.5), (25, -4.2), (30, -4),
        (35, -3), (40, -1.8), (45, -0.8), (50, -0.5), (55, -1), (60, -2),
        (65, -3.2), (70, -4.5), (75, -5),
    ],
    dtype=np.float32,
)

_ROAD_X = jnp.asarray(ROAD_WPS[:, 0])
_ROAD_Y = jnp.asarray(ROAD_WPS[:, 1])


_ROAD_DX = 5.0  # ROAD_WPS x-knots are uniform; checked below
assert np.allclose(np.diff(ROAD_WPS[:, 0]), _ROAD_DX)


def road_y(x):
    """Piecewise-linear road centreline y(x), clamped at the ends.

    Implemented as an exact hat-function (linear B-spline) sum over the
    uniformly spaced knots instead of ``jnp.interp``: interp lowers to a
    gather-based searchsorted over the 2.3M samples of a 15-route raycast.
    The unrolled 36-term clip/fma chain is pure element-wise work that XLA
    fuses into the surrounding march."""
    x = jnp.asarray(x, jnp.float32)
    xc = jnp.clip(x, float(ROAD_WPS[0, 0]), float(ROAD_WPS[-1, 0]))
    y = jnp.zeros_like(xc)
    for xk, yk in ROAD_WPS:
        w = jnp.clip(1.0 - jnp.abs(xc - float(xk)) / _ROAD_DX, 0.0, 1.0)
        y = y + w * float(yk)
    return y


def _terrain_height_impl(x, y, xp):
    """Backend-parameterized terrain formula (xp = jnp for traced/device
    use, np for the eager texture bake — one formula, no drift)."""
    h = 0.5 * xp.sin(x * 0.018 + 0.5) * xp.cos(y * 0.022 + 1.2)
    h += 0.35 * xp.sin(x * 0.035 + 2.1) * xp.sin(y * 0.03 + 0.7)
    h += 0.18 * xp.sin(x * 0.07 + 3.3) * xp.cos(y * 0.065 + 2.5)
    h += 0.12 * xp.cos(x * 0.11 + 1.0) * xp.sin(y * 0.09 + 4.0)
    h += 0.06 * xp.sin(x * 0.5 + 0.7) * xp.cos(y * 0.43 + 2.1)
    h += 0.04 * xp.cos(x * 0.7 + 3.5) * xp.sin(y * 0.6 + 0.4)
    h += 0.03 * xp.sin(x * 1.0 + 1.2) * xp.cos(y * 0.83 + 3.8)

    # numpy bake path: plain interp; jnp path: gather-free hat-sum road_y
    road = np.interp(x, ROAD_WPS[:, 0], ROAD_WPS[:, 1]) if xp is np \
        else road_y(x)
    road_dist = xp.abs(y - road)
    flatten = xp.where(road_dist < 4.0, (road_dist / 4.0) ** 2, 1.0)
    h = h * flatten
    h = h - xp.where(road_dist < 2.0, 0.06 * (1.0 - road_dist / 2.0), 0.0)
    return xp.maximum(h, -0.5)


def terrain_height(x, y):
    """Closed-form terrain height, vectorized over any batch shape.

    Multi-octave sine hills + small forest-floor bumps, quadratically
    flattened within 4 m of the road and slightly sunk (6 cm crown) within
    2 m — behaviorally identical to the reference heightfield.
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    return _terrain_height_impl(x, y, jnp)


def terrain_normal(x, y, eps: float = 0.2):
    """Finite-difference surface normal (unit vector, z-up)."""
    hx = (terrain_height(x + eps, y) - terrain_height(x - eps, y)) / (2 * eps)
    hy = (terrain_height(x, y + eps) - terrain_height(x, y - eps)) / (2 * eps)
    n = jnp.stack([-hx, -hy, jnp.ones_like(hx)], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def terrain_pitch_roll(x, y, yaw, eps: float = 0.3):
    """Robot pitch/roll implied by terrain slope under heading ``yaw``.

    Matches how a wheeled base settles on the surface: pitch from the
    along-track slope, roll from the cross-track slope.
    """
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    h0 = terrain_height(x, y)
    h_fwd = terrain_height(x + eps * c, y + eps * s)
    h_lat = terrain_height(x - eps * s, y + eps * c)
    pitch = jnp.arctan2(-(h_fwd - h0), eps)   # nose-up positive
    roll = jnp.arctan2(h_lat - h0, eps)
    return pitch, roll


# ---- baked bilinear terrain texture (raycaster fast path) ----
#
# The analytic field costs ~14 transcendentals + a 36-knot road interp per
# query; the depth raycaster issues ~2.3M queries per 15-route render call
# and profiles as ~78 % of the whole repeat tick.  The terrain is globally
# static, so the raycaster samples a baked grid instead: 0.25 m bilinear
# resolution keeps the error far below the depth sensor's own noise floor
# (see test_scene.py::test_terrain_tex_matches_analytic).  Dynamics and the
# drift-sensitive pose math keep the exact analytic field.

TEX_RES = 0.25
TEX_X0, TEX_Y0 = -140.0, -100.0
TEX_NX, TEX_NY = 1121, 801            # covers x in [-140, 140], y in [-100, 100]

_TEX_CACHE = None


def terrain_tex() -> np.ndarray:
    """Baked (TEX_NY, TEX_NX) float32 height grid (built once, on CPU)."""
    global _TEX_CACHE
    if _TEX_CACHE is None:
        xs = TEX_X0 + TEX_RES * np.arange(TEX_NX, dtype=np.float32)
        ys = TEX_Y0 + TEX_RES * np.arange(TEX_NY, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys)
        # pure-numpy bake: safe to trigger lazily even inside a jax trace
        _TEX_CACHE = _terrain_height_impl(
            gx.astype(np.float32), gy.astype(np.float32), np
        ).astype(np.float32)
    return _TEX_CACHE


def terrain_height_tex(x, y):
    """Bilinear sample of the baked grid (coordinates clamped to its
    bounds).  Drop-in for ``terrain_height`` inside the raycaster."""
    tex = jnp.asarray(terrain_tex())
    fx = jnp.clip((jnp.asarray(x, jnp.float32) - TEX_X0) / TEX_RES,
                  0.0, TEX_NX - 1.001)
    fy = jnp.clip((jnp.asarray(y, jnp.float32) - TEX_Y0) / TEX_RES,
                  0.0, TEX_NY - 1.001)
    ix = fx.astype(jnp.int32)
    iy = fy.astype(jnp.int32)
    ax = fx - ix
    ay = fy - iy
    h00 = tex[iy, ix]
    h01 = tex[iy, ix + 1]
    h10 = tex[iy + 1, ix]
    h11 = tex[iy + 1, ix + 1]
    return (h00 * (1 - ax) * (1 - ay) + h01 * ax * (1 - ay)
            + h10 * (1 - ax) * ay + h11 * ax * ay)

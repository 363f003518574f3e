"""Batched differential-drive UGV dynamics on the analytic terrain.

Batched replacement for Isaac/PhysX rigid-body stepping
(run_husky_forest.py:430-441,1056-1073): the Husky is modeled as a
diff-drive unicycle with first-order wheel-drive lag, multiplicative wheel
slip noise, and terrain-conforming attitude.  200 Hz substeps with the
reference's 20:1 sensor decimation; the whole state advance is pure
``lax.scan`` so it jits once and vmaps over the route batch.

Collision is resolved kinematically: motion into an inflated collider disc
is cancelled (the robot "wedges"), which is exactly the contact behavior the
pure-pursuit wedge-recovery branch (pure_pursuit_path_follower.py:47-52)
exists to escape.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nclt_slam_tpu.config import SimConfig
from nclt_slam_tpu.core.quat import quat_from_yaw, quat_mul
from nclt_slam_tpu.scene.terrain import terrain_height, terrain_pitch_roll

ROBOT_RADIUS = 0.4        # Husky half-footprint (generate_routes.py ROBOT_R)
CHASSIS_CLEARANCE = 0.13  # base_link height above contact


class RobotState(NamedTuple):
    xy: jax.Array        # (2,) world position
    yaw: jax.Array       # () heading
    v: jax.Array         # () actual forward speed (after drive lag)
    w: jax.Array         # () actual yaw rate
    wedged: jax.Array    # () bool — last substep was blocked by a collider


def init_robot(x, y, yaw) -> RobotState:
    f = jnp.float32
    return RobotState(
        xy=jnp.array([x, y], jnp.float32),
        yaw=f(yaw), v=f(0.0), w=f(0.0), wedged=jnp.array(False),
    )


def _collider_block(xy_new, xy_old, obs_xy, obs_r, obs_valid):
    """Cancel motion that would penetrate a collider disc.

    Returns (xy, blocked).  One pass is enough at 200 Hz step sizes
    (<5 mm/substep)."""
    d = jnp.linalg.norm(xy_new[None, :] - obs_xy, axis=-1)
    pen = (d < obs_r + ROBOT_RADIUS) & obs_valid
    blocked = jnp.any(pen)
    return jnp.where(blocked, xy_old, xy_new), blocked


def substep(state: RobotState, cmd_v, cmd_w, obs_xy, obs_r, obs_valid,
            key, cfg: SimConfig) -> RobotState:
    """One 200 Hz physics step."""
    dt = 1.0 / cfg.physics_hz

    # wheel-level command mixing + clamp (diff-drive kinematics,
    # wheel_r/track from the reference Husky model)
    half_track = 0.5 * cfg.track_width
    vl = (cmd_v - cmd_w * half_track) / cfg.wheel_radius
    vr = (cmd_v + cmd_w * half_track) / cfg.wheel_radius
    vl = jnp.clip(vl, -cfg.max_wheel_speed, cfg.max_wheel_speed)
    vr = jnp.clip(vr, -cfg.max_wheel_speed, cfg.max_wheel_speed)
    v_tgt = 0.5 * (vl + vr) * cfg.wheel_radius
    w_tgt = (vr - vl) * cfg.wheel_radius / cfg.track_width

    # first-order drive lag (PhysX DriveAPI behaves like a velocity servo)
    a_v = 1.0 - jnp.exp(-dt / cfg.v_tau)
    a_w = 1.0 - jnp.exp(-dt / cfg.w_tau)
    v = state.v + a_v * (v_tgt - state.v)
    w = state.w + a_w * (w_tgt - state.w)

    # wheel-terrain slip noise (multiplicative, zero-mean)
    k1, k2 = jax.random.split(key)
    v = v * (1.0 + cfg.slip_std * jax.random.normal(k1))
    w = w * (1.0 + cfg.slip_std * jax.random.normal(k2))

    yaw = state.yaw + w * dt
    step = jnp.array([jnp.cos(yaw), jnp.sin(yaw)]) * (v * dt)
    xy_new, blocked = _collider_block(state.xy + step, state.xy,
                                      obs_xy, obs_r, obs_valid)
    v = jnp.where(blocked, 0.0, v)
    return RobotState(xy=xy_new, yaw=jnp.arctan2(jnp.sin(yaw), jnp.cos(yaw)),
                      v=v, w=w, wedged=blocked)


def robot_pose3d(state: RobotState):
    """Full 3D pose implied by the terrain: (pos (3,), quat xyzw (4,)).

    The base settles on the heightfield; pitch/roll follow the local slope —
    this is what feeds the synthetic IMU's double-differentiation chain.
    """
    x, y = state.xy[0], state.xy[1]
    z = terrain_height(x, y) + CHASSIS_CLEARANCE
    pitch, roll = terrain_pitch_roll(x, y, state.yaw)
    q_yaw = quat_from_yaw(state.yaw)
    q_pitch = jnp.array([0.0, jnp.sin(pitch / 2), 0.0, jnp.cos(pitch / 2)])
    q_roll = jnp.array([jnp.sin(roll / 2), 0.0, 0.0, jnp.cos(roll / 2)])
    q = quat_mul(q_yaw, quat_mul(q_pitch, q_roll))
    return jnp.array([x, y, z]), q


def nav_substeps(state: RobotState, cmd_v, cmd_w, obs_xy, obs_r, obs_valid,
                 key, cfg: SimConfig):
    """Run one nav tick = ``cfg.nav_decimation`` physics substeps.

    Returns (new_state, traj) where traj carries per-substep (pos, quat)
    for the 200 Hz IMU model."""

    def body(s, k):
        s2 = substep(s, cmd_v, cmd_w, obs_xy, obs_r, obs_valid, k, cfg)
        pos, quat = robot_pose3d(s2)
        return s2, (pos, quat)

    keys = jax.random.split(key, cfg.nav_decimation)
    return jax.lax.scan(body, state, keys)

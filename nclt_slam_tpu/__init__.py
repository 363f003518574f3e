"""nclt_slam_tpu — batched teach-and-repeat simulation + navigation framework.

A ground-up JAX/XLA rebuild of the capabilities of the
vbronetskyi/nclt-slam-project reference (Visual-Inertial SLAM and Navigation
for an outdoor UGV).  Instead of the reference's 7-9-process ROS2 graph, the
entire teach/repeat inner loop is one pure jitted function rolled with
``lax.scan`` and ``vmap``-ed over the (route, ablation) batch axis.

Layer map (bottom-up), mirroring SURVEY.md §7:

- ``core``      SE(2)/SE(3)/quaternion math, RNG streams, fixed-size containers
- ``scene``     analytic terrain + procedural forest colliders + route registry
- ``dynamics``  batched diff-drive UGV step on the heightfield
- ``sensors``   depth raycaster, synthetic IMU, encoder/compass models
- ``vio``       IMU preintegration, feature tracking, PnP-RANSAC, sliding-window BA
- ``landmarks`` teach-time landmark recorder + repeat-time visual anchor matcher
- ``fusion``    the 4-regime pose-fusion relay (no_anchor / ok / strong / jump)
- ``mapping``   log-odds occupancy grid + inflation costmap
- ``planning``  wavefront global planner, WP projection, detour ring, dispatcher
- ``control``   pure-pursuit follower + proximity/anti-spin/wedge recovery
- ``rollout``   scan+vmap orchestration, traces, checkpoints
- ``eval``      coverage/endpoint/drift metrics, ATE/RPE
- ``io``        reference-format artefact interop (landmarks.pkl, PGM/YAML maps, CSV)
- ``parallel``  device-mesh sharding of the route batch
- ``ops``       CUDA kernels for the hot paths, called through the XLA FFI
"""

__version__ = "0.1.0"

import jax as _jax

# Pose/geometry math needs true f32 matmuls: without this a GPU may run f32
# matmuls in TF32 (about three decimal digits), which breaks SE(3) round
# trips at the 1e-3 level.  Code that wants reduced-precision throughput
# asks for it explicitly via preferred_element_type/dtypes.
_jax.config.update("jax_default_matmul_precision", "highest")

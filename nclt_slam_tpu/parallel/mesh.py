"""Multi-GPU scaling: shard the route/ablation batch over a device mesh.

The reference has no distributed story (SURVEY.md §2.4 — its only
parallelism is OS processes + sequential route batches).  Our batch axis is
(route × ablation), which is embarrassingly parallel — so the sharding
design is: one flat mesh axis ``routes`` over the cards, every batched
input (scenes, routes, teach grids, waypoints, landmark stores) sharded
along its leading axis.  No collectives are needed in the rollout itself;
metrics reductions happen post-hoc on the host.  The cards of one host
reach each other all to all over NVLink, so the mesh follows the batch
alone, and the only transfers are the initial scatter and the final
gather, which XLA inserts from the shardings.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nclt_slam_tpu.config import Config


def route_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("routes",))


def pad_batch(tree, multiple: int):
    """Pad every leaf's leading (route) axis up to a multiple so it shards
    evenly; padding replicates the last route (masked out in metrics)."""

    def pad(x):
        b = x.shape[0]
        rem = (-b) % multiple
        if rem == 0:
            return x
        fill = jnp.repeat(x[-1:], rem, axis=0)
        return jnp.concatenate([x, fill], axis=0)

    return jax.tree_util.tree_map(pad, tree)


def shard_over_routes(tree, mesh: Mesh):
    """Place each leaf with its leading axis split over the ``routes`` axis."""
    sharding = NamedSharding(mesh, P("routes"))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(put, tree)


def sharded_campaign_repeat(data, teach_grids, wps, n_wps, cfg: Config,
                            n_ticks: int, stores=None,
                            mesh: Mesh | None = None, **kw):
    """Run the batched repeat campaign with the route axis sharded over the
    mesh (one card: a degenerate mesh).  The batch, the teach landmark
    ``stores`` included, is padded to a multiple of the mesh size with
    copies of the last route; the result keeps the padded routes (the
    first ``len(data.names)`` are the real ones).  ``kw`` goes on to
    ``run_campaign_repeat`` (chunk, progress, stop_when_done, ...)."""
    from nclt_slam_tpu.landmarks.store import init_store
    from nclt_slam_tpu.rollout.campaign import CampaignData, run_campaign_repeat

    mesh = mesh or route_mesh()
    n = len(mesh.devices.flat)
    if stores is None:
        stores = jax.vmap(lambda _: init_store(cfg.landmarks))(
            jnp.arange(wps.shape[0]))
    batch = (data.scenes_repeat, data.routes, teach_grids, wps, n_wps,
             stores)
    scenes, routes, tg, wp, nw, st = shard_over_routes(
        pad_batch(batch, n), mesh)
    n_pad = wp.shape[0] - len(data.names)
    names = tuple(data.names) + tuple(f"pad{i}" for i in range(n_pad))
    view = CampaignData(scenes_teach=scenes, scenes_repeat=scenes,
                        routes=routes, names=names)
    return run_campaign_repeat(view, tg, wp, nw, cfg, n_ticks, stores=st,
                               **kw)

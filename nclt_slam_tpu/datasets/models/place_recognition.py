"""LiDAR place recognition scaffold — the MinkLoc3D equivalent.

The reference scaffolds MinkLoc3D (MinkowskiEngine sparse conv + GeM +
triplet loss with hard mining, datasets/nclt_kaggle/src/models/
place_recognition.py:24-167) but never trains it.  Without a sparse-conv
engine, this formulation voxelizes each scan onto a dense occupancy grid
and runs a small 3-D conv encoder — dense conv maps onto the matrix
units.  GeM pooling, triplet margin loss with batch-hard
mining, and the Recall@K protocol match the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

VOXEL_GRID = (32, 32, 16)   # x, y, z cells
VOXEL_RANGE = ((-40.0, 40.0), (-40.0, 40.0), (-4.0, 12.0))
EMBED_DIM = 128


def voxelize(pts, valid, grid=VOXEL_GRID, rng=VOXEL_RANGE):
    """Scan (N, 3) -> dense occupancy grid (X, Y, Z) float32."""
    lo = jnp.array([r[0] for r in rng])
    hi = jnp.array([r[1] for r in rng])
    g = jnp.array(grid)
    cell = ((pts - lo) / (hi - lo) * g).astype(jnp.int32)
    inside = jnp.all((cell >= 0) & (cell < g), -1) & valid
    flat = (cell[:, 0] * grid[1] + cell[:, 1]) * grid[2] + cell[:, 2]
    occ = jnp.zeros(grid[0] * grid[1] * grid[2], jnp.float32)
    occ = occ.at[jnp.where(inside, flat, 0)].max(inside.astype(jnp.float32))
    return occ.reshape(grid)


class PRParams(NamedTuple):
    """Conv encoder parameters (3 conv blocks + projection)."""

    w1: jax.Array  # (3, 3, 3, 1, 16)
    w2: jax.Array  # (3, 3, 3, 16, 32)
    w3: jax.Array  # (3, 3, 3, 32, 64)
    proj: jax.Array  # (64, EMBED_DIM)
    gem_p: jax.Array  # () GeM exponent


def init_params(key) -> PRParams:
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def conv_init(k, shape):
        fan_in = shape[0] * shape[1] * shape[2] * shape[3]
        return jax.random.normal(k, shape) * jnp.sqrt(2.0 / fan_in)

    return PRParams(
        w1=conv_init(k1, (3, 3, 3, 1, 16)),
        w2=conv_init(k2, (3, 3, 3, 16, 32)),
        w3=conv_init(k3, (3, 3, 3, 32, 64)),
        proj=jax.random.normal(k4, (64, EMBED_DIM)) * jnp.sqrt(1.0 / 64),
        gem_p=jnp.float32(3.0),
    )


def _conv3d(x, w, stride):
    return jax.lax.conv_general_dilated(
        x, w, window_strides=(stride,) * 3, padding="SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


def embed(params: PRParams, grids):
    """Occupancy grids (B, X, Y, Z) -> L2-normalized embeddings (B, D)."""
    x = grids[..., None]                              # (B, X, Y, Z, 1)
    x = jax.nn.relu(_conv3d(x, params.w1, 2))
    x = jax.nn.relu(_conv3d(x, params.w2, 2))
    x = jax.nn.relu(_conv3d(x, params.w3, 2))         # (B, 4, 4, 2, 64)
    # GeM pooling over spatial dims
    p = jnp.maximum(params.gem_p, 1.0)
    x = jnp.clip(x, 1e-6, None) ** p
    x = x.mean(axis=(1, 2, 3)) ** (1.0 / p)           # (B, 64)
    e = x @ params.proj
    return e / (jnp.linalg.norm(e, axis=-1, keepdims=True) + 1e-9)


def triplet_loss_hard(emb, labels, margin: float = 0.5):
    """Batch-hard triplet margin loss (hardest positive + hardest negative
    per anchor, like the reference's hard-mining sampler)."""
    # epsilon inside the sqrt: the self-distance diagonal is masked out
    # below, but grad(norm) at exactly 0 is NaN and ``where`` does not stop
    # NaN gradients from the untaken branch
    d2 = ((emb[:, None] - emb[None, :]) ** 2).sum(-1)
    d = jnp.sqrt(d2 + 1e-9)
    same = labels[:, None] == labels[None, :]
    eye = jnp.eye(len(labels), dtype=bool)
    pos = same & ~eye
    neg = ~same
    hardest_pos = jnp.where(pos, d, -jnp.inf).max(1)
    hardest_neg = jnp.where(neg, d, jnp.inf).min(1)
    has_pair = pos.any(1) & neg.any(1)
    loss = jnp.maximum(hardest_pos - hardest_neg + margin, 0.0)
    return jnp.where(has_pair, loss, 0.0).mean()


def train_step(params: PRParams, grids, labels, lr: float = 1e-3):
    """One SGD step on the triplet loss; returns (params, loss)."""
    loss, grads = jax.value_and_grad(
        lambda p: triplet_loss_hard(embed(p, grids), labels))(params)
    new = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return new, loss


def recall_at_k(query_emb, db_emb, query_labels, db_labels, k: int = 1):
    """Recall@K retrieval metric (reference eval protocol)."""
    d = jnp.linalg.norm(query_emb[:, None] - db_emb[None, :], axis=-1)
    idx = jnp.argsort(d, axis=1)[:, :k]
    hits = (db_labels[idx] == query_labels[:, None]).any(1)
    return hits.mean()

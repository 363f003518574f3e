"""UTM-threshold pair mining for place-recognition training.

Re-implements the reference's NCLT Kaggle pair-mining protocol
(datasets/nclt_kaggle/src/datasets/nclt_pairs.py:243-305 +
configs/dataset_config.yaml:33-39) in fixed shapes:

- session-date split registry (train 4 / val 2 / test 4 sessions)
- per-anchor mining: the CLOSEST pose within ``positive_threshold`` (10 m,
  excluding the anchor itself) is the positive; ``num_negatives`` (5)
  drawn uniformly from poses beyond ``negative_threshold`` (25 m);
  anchors with no positive or too few negatives are dropped
- hard-negative mining in descriptor space (top-k nearest negatives,
  nclt_pairs.py:307-330)

The reference builds a python KDTree and loops anchors; here mining is a
single vectorized distance computation blocked over anchors (numpy,
offline — the output feeds fixed-shape device batches), and hard-negative
mining is a batched jnp top-k usable on device inside the training loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# session split registry (dataset_config.yaml:33-35)
TRAIN_SESSIONS = ("2012-01-08", "2012-01-22", "2012-02-12", "2012-02-18")
VAL_SESSIONS = ("2012-03-31", "2012-05-26")
TEST_SESSIONS = ("2012-08-04", "2012-10-28", "2012-11-04", "2012-12-01")

POSITIVE_THRESHOLD_M = 10.0
NEGATIVE_THRESHOLD_M = 25.0
NUM_NEGATIVES = 5


def sessions_for_split(split: str) -> tuple[str, ...]:
    try:
        return {"train": TRAIN_SESSIONS, "val": VAL_SESSIONS,
                "test": TEST_SESSIONS}[split]
    except KeyError:
        raise ValueError(f"Invalid split '{split}' "
                         "(must be train/val/test)") from None


class MinedPairs(NamedTuple):
    anchor: np.ndarray     # (M,) indices into the pose array
    positive: np.ndarray   # (M,)
    negatives: np.ndarray  # (M, num_negatives)


def mine_pairs(coords: np.ndarray,
               positive_threshold: float = POSITIVE_THRESHOLD_M,
               negative_threshold: float = NEGATIVE_THRESHOLD_M,
               num_negatives: int = NUM_NEGATIVES,
               seed: int = 42, block: int = 512) -> MinedPairs:
    """Mine (anchor, closest-positive, random-negatives) index triples.

    coords: (N, 3) pose positions (UTM / world).  Behavior matches the
    reference loop exactly: positives strictly within the threshold
    excluding self; the positive is the CLOSEST such pose; negatives are
    sampled without replacement beyond the negative threshold; anchors
    lacking either are skipped."""
    coords = np.asarray(coords, np.float64)
    N = len(coords)
    rng = np.random.default_rng(seed)
    anchors, positives, negatives = [], [], []

    for s in range(0, N, block):
        blk = coords[s:s + block]                        # (B, 3)
        d = np.linalg.norm(blk[:, None, :] - coords[None, :, :], axis=-1)
        d[np.arange(len(blk)), s + np.arange(len(blk))] = np.inf  # self
        pos_ok = d < positive_threshold
        has_pos = pos_ok.any(axis=1)
        best_pos = np.argmin(np.where(pos_ok, d, np.inf), axis=1)
        # isfinite: the self-distance was poisoned to inf above, which
        # would otherwise pass the > threshold test
        neg_ok = (d > negative_threshold) & np.isfinite(d)

        for i in np.where(has_pos)[0]:
            neg_idx = np.where(neg_ok[i])[0]
            if len(neg_idx) < num_negatives:
                continue
            anchors.append(s + i)
            positives.append(best_pos[i])
            negatives.append(rng.choice(neg_idx, size=num_negatives,
                                        replace=False))

    if not anchors:
        return MinedPairs(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros((0, num_negatives), np.int32))
    return MinedPairs(np.asarray(anchors, np.int32),
                      np.asarray(positives, np.int32),
                      np.stack(negatives).astype(np.int32))


def hard_negatives(anchor_desc, cand_desc, k: int):
    """Descriptor-space hard-negative mining (nclt_pairs.py:307-330), as a
    batched device op: anchor_desc (B, D), cand_desc (B, C, D) -> (B, k)
    indices of the k nearest (= hardest) candidates per anchor."""
    d = jnp.linalg.norm(cand_desc - anchor_desc[:, None, :], axis=-1)
    _, idx = jax.lax.top_k(-d, k)
    return idx


def pairs_epoch_batches(pairs: MinedPairs, batch: int, seed: int = 0):
    """Shuffle mined pairs and yield fixed-shape index batches (drop the
    ragged tail — static shapes for jit)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs.anchor))
    for s in range(0, len(order) - batch + 1, batch):
        sel = order[s:s + batch]
        yield (pairs.anchor[sel], pairs.positive[sel], pairs.negatives[sel])


def triplet_loss_pairs(emb_a, emb_p, emb_n, margin: float = 0.5):
    """Triplet margin loss over mined pairs with in-batch hard mining:
    emb_a/emb_p (B, D), emb_n (B, K, D).  The hardest (nearest) negative
    per anchor drives the hinge — the reference's MinkLoc training
    objective applied to the mined (anchor, positive, negatives) tuples."""
    d_pos = jnp.linalg.norm(emb_a - emb_p, axis=-1)
    d_neg = jnp.linalg.norm(emb_n - emb_a[:, None, :], axis=-1).min(axis=-1)
    return jnp.maximum(margin + d_pos - d_neg, 0.0).mean()

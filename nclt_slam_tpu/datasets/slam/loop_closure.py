"""Loop closure: ScanContext descriptors + 2-D pose-graph optimization.

Capability match for datasets/nclt/src/slam/loop_closure.py: the polar
ScanContext descriptor (60 azimuth sectors x 20 range rings) with
rotation-invariant ring-shift matching, a GPS-gated candidate search, and
the custom damped Gauss-Newton 2-D pose-graph optimizer (odometry weight 1,
loop-closure weight 10 — PoseGraphOptimizer2D.optimize:136)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

N_SECTORS = 60
N_RINGS = 20
MAX_RANGE = 80.0


def scan_context(pts, valid, n_sectors: int = N_SECTORS,
                 n_rings: int = N_RINGS, max_range: float = MAX_RANGE):
    """Polar max-height descriptor (n_rings, n_sectors) of a scan."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rng = jnp.hypot(x, y)
    ang = jnp.arctan2(y, x)  # [-pi, pi)
    ring = jnp.clip((rng / max_range * n_rings).astype(jnp.int32),
                    0, n_rings - 1)
    sector = jnp.clip(((ang + jnp.pi) / (2 * jnp.pi) * n_sectors)
                      .astype(jnp.int32), 0, n_sectors - 1)
    flat = ring * n_sectors + sector
    ok = valid & (rng < max_range)
    desc = jnp.full(n_rings * n_sectors, -jnp.inf)
    desc = desc.at[jnp.where(ok, flat, 0)].max(jnp.where(ok, z, -jnp.inf))
    desc = jnp.where(jnp.isfinite(desc), desc, 0.0)
    return desc.reshape(n_rings, n_sectors)


def sc_distance(d1, d2):
    """Rotation-invariant ScanContext distance: min over column shifts of
    the whole-descriptor cosine distance (reference distance_rot,
    loop_closure.py:49-64 — flattened dot product, so empty cells
    contribute nothing instead of counting as full mismatch)."""
    v1 = d1.reshape(-1)
    n1 = jnp.linalg.norm(v1)
    v1n = v1 / jnp.maximum(n1, 1e-6)

    def shift_dist(shift):
        v2 = jnp.roll(d2, shift, axis=1).reshape(-1)
        n2 = jnp.linalg.norm(v2)
        return jnp.where(n2 < 1e-6, 1.0,
                         1.0 - v1n @ (v2 / jnp.maximum(n2, 1e-6)))

    dists = jax.vmap(shift_dist)(jnp.arange(d1.shape[1]))
    dists = jnp.where(n1 < 1e-6, jnp.ones_like(dists), dists)
    return dists.min(), jnp.argmin(dists)


def detect_loops(descs, positions, valid, min_gap: int = 50,
                 gps_radius: float = 10.0, sc_thresh: float = 0.25,
                 max_loops: int = 32):
    """GPS-gated loop detection over a batch of descriptors.

    descs (K, R, S), positions (K, 2).  Returns fixed-size arrays
    (i_idx, j_idx, found) of up to ``max_loops`` loop pairs (best-first)."""
    K = descs.shape[0]
    d_pos = jnp.linalg.norm(positions[:, None] - positions[None, :], axis=-1)
    gap = jnp.abs(jnp.arange(K)[:, None] - jnp.arange(K)[None, :])
    cand = (d_pos < gps_radius) & (gap > min_gap) & \
        valid[:, None] & valid[None, :]
    cand = jnp.triu(cand)  # i < j only

    def pair_dist(i, j):
        d, _ = sc_distance(descs[i], descs[j])
        return d

    ii, jj = jnp.meshgrid(jnp.arange(K), jnp.arange(K), indexing="ij")
    dists = jax.vmap(jax.vmap(
        lambda i, j, c: jnp.where(c, pair_dist(i, j), jnp.inf)))(
        ii, jj, cand)
    flat = dists.reshape(-1)
    order = jnp.argsort(flat)[:max_loops]
    found = jnp.isfinite(flat[order]) & (flat[order] < sc_thresh)
    return order // K, order % K, found


def ring_key(desc):
    """Rotation-invariant ring key: per-ring mean occupancy (R,) — the
    ScanContext paper's first-stage search key.  Column shifts permute
    sectors within a ring, so the ring mean is shift-invariant."""
    return desc.mean(axis=-1)


def detect_loops_scalable(descs, positions, valid, min_gap: int = 50,
                          gps_radius: float = 10.0, sc_thresh: float = 0.25,
                          max_loops: int = 32, shortlist: int = 256):
    """Two-stage loop detection for long sessions (the K^2 full-descriptor
    sweep in detect_loops costs ~1 MFLOP/pair — hopeless at K >= 2000).

    Stage 1: ring-key L1 distance over all gated pairs (one (K, K, R)
    reduction — cheap).  Stage 2: full rotation-search ScanContext distance
    on only the ``shortlist`` best candidates.  Same thresholds/semantics
    as detect_loops; identical results whenever the shortlist covers the
    true candidates.
    """
    K = descs.shape[0]
    d_pos = jnp.linalg.norm(positions[:, None] - positions[None, :], axis=-1)
    gap = jnp.abs(jnp.arange(K)[:, None] - jnp.arange(K)[None, :])
    cand = (d_pos < gps_radius) & (gap > min_gap) & \
        valid[:, None] & valid[None, :]
    cand = jnp.triu(cand)

    keys = ring_key(descs)                                    # (K, R)
    key_d = jnp.abs(keys[:, None, :] - keys[None, :, :]).mean(-1)
    key_d = jnp.where(cand, key_d, jnp.inf)

    flat = key_d.reshape(-1)
    short = jnp.argsort(flat)[:shortlist]                     # best ring-keys
    si, sj = short // K, short % K
    s_ok = jnp.isfinite(flat[short])

    def full_dist(i, j, ok):
        d, _ = sc_distance(descs[i], descs[j])
        return jnp.where(ok, d, jnp.inf)

    dists = jax.vmap(full_dist)(si, sj, s_ok)                 # (shortlist,)
    order = jnp.argsort(dists)[:max_loops]
    found = jnp.isfinite(dists[order]) & (dists[order] < sc_thresh)
    return si[order], sj[order], found


class PoseGraph2D(NamedTuple):
    """Fixed-size 2-D pose graph: K poses, E odometry edges (chain) and
    L loop edges."""

    poses: jax.Array      # (K, 3) x, y, theta
    odo_meas: jax.Array   # (K-1, 3) relative measurements
    loop_i: jax.Array     # (L,)
    loop_j: jax.Array     # (L,)
    loop_meas: jax.Array  # (L, 3)
    loop_valid: jax.Array  # (L,)


def _rel_residual(pi, pj, meas):
    """SE(2) relative residual between poses pi -> pj vs measurement."""
    c, s = jnp.cos(pi[2]), jnp.sin(pi[2])
    dx = pj[0] - pi[0]
    dy = pj[1] - pi[1]
    rx = c * dx + s * dy - meas[0]
    ry = -s * dx + c * dy - meas[1]
    rt = jnp.arctan2(jnp.sin(pj[2] - pi[2] - meas[2]),
                     jnp.cos(pj[2] - pi[2] - meas[2]))
    return jnp.array([rx, ry, rt])


def optimize_pose_graph(graph: PoseGraph2D, iters: int = 20,
                        odo_w=1.0, lc_w: float = 10.0,
                        damping: float = 1e-3) -> jax.Array:
    """Damped GN over the full 2-D pose graph (custom optimizer port:
    odom_w=1, lc_w=10, first pose pinned).  Returns optimized poses (K, 3).

    ``odo_w`` may be a scalar or a per-edge (K-1,) array (the reduced graph
    from reduce_pose_graph carries composed-segment weights).

    Dense (3K x 3K) normal equations — at the reference's scale (a few
    hundred keyframes) that is a small dense solve per iteration.  For
    km-scale sessions use optimize_pose_graph_fast (junction reduction)."""
    K = graph.poses.shape[0]
    odo_w_sqrt = jnp.sqrt(jnp.broadcast_to(
        jnp.asarray(odo_w, jnp.float32), (K - 1,)))[:, None]

    def residual_all(poses_flat):
        poses = poses_flat.reshape(K, 3)
        r_odo = (odo_w_sqrt * jax.vmap(_rel_residual)(
            poses[:-1], poses[1:], graph.odo_meas)).reshape(-1)
        r_lc = jax.vmap(_rel_residual)(
            poses[graph.loop_i], poses[graph.loop_j],
            graph.loop_meas)
        r_lc = (r_lc * graph.loop_valid[:, None]).reshape(-1)
        r_prior = poses[0] - graph.poses[0]
        return jnp.concatenate([
            r_odo,
            jnp.sqrt(lc_w) * r_lc,
            100.0 * r_prior,
        ])

    def gn(poses_flat, _):
        r = residual_all(poses_flat)
        J = jax.jacfwd(residual_all)(poses_flat)
        H = J.T @ J + damping * jnp.eye(3 * K)
        g = J.T @ r
        return poses_flat - jnp.linalg.solve(H, g), (r ** 2).sum()

    flat, costs = jax.lax.scan(gn, graph.poses.reshape(-1), None,
                               length=iters)
    return flat.reshape(K, 3)


# ---------------------------------------------------------------------------
# km-scale PGO: junction reduction + closed-form interior recovery
# ---------------------------------------------------------------------------
#
# The dense optimizer above is exact but O(K^3): at the NCLT ladder's 2000
# poses the jacfwd Jacobian alone is a (6K, 3K) = 145 MB materialization per
# iteration.  Structure saves us: only the loop-edge endpoints (plus the two
# chain ends) are genuinely coupled — every interior chain pose hangs off its
# segment by odometry factors alone, so (in the linearized Gaussian sense) it
# can be marginalized exactly into a single composed relative factor between
# its segment's endpoints, and recovered afterwards by distributing the
# endpoint discrepancy along the segment.  The reduced problem has
# Kr <= 2 + 2L poses (a few hundred, not thousands), a small dense GN
# solve per iteration.  Capability reference:
# the reference's PoseGraphOptimizer2D (datasets/nclt/src/slam/
# loop_closure.py:136) runs dense GN at a few hundred keyframes; this path
# carries the same semantics to km-scale sessions.


def _odo_chain(poses, odo):
    """Vectorized open-loop chain from pose 0 through all odometry edges:
    G[k] = T(poses[0]) ∘ m_0 ∘ ... ∘ m_{k-1}  (numpy, (K, 3))."""
    th = np.concatenate([[poses[0, 2]],
                         poses[0, 2] + np.cumsum(odo[:, 2])])
    c, s = np.cos(th[:-1]), np.sin(th[:-1])
    steps = np.stack([c * odo[:, 0] - s * odo[:, 1],
                      s * odo[:, 0] + c * odo[:, 1]], -1)
    xy = np.concatenate([poses[0:1, :2],
                         poses[0, :2] + np.cumsum(steps, axis=0)])
    return np.column_stack([xy, th]).astype(np.float32)


def reduce_pose_graph(graph: PoseGraph2D, odo_w: float = 1.0):
    """Marginalize interior chain poses (host-side numpy, fully vectorized
    through the global odometry chain — no per-edge python loop).

    Returns (reduced PoseGraph2D, odo_w_reduced (Kr-1,), junctions (Kr,)).
    Composed segment weight = odo_w / n_edges: information of a chain of
    n identical isotropic relative factors composes to ~1/n (lever-arm
    cross terms ignored — the same isotropic approximation the reference's
    optimizer makes for its own factors)."""
    poses = np.asarray(graph.poses)
    odo = np.asarray(graph.odo_meas)
    li = np.asarray(graph.loop_i)
    lj = np.asarray(graph.loop_j)
    valid = np.asarray(graph.loop_valid)
    K = len(poses)

    ends = np.concatenate([[0, K - 1], li[valid], lj[valid]])
    junctions = np.unique(ends.astype(np.int64))
    Kr = len(junctions)

    # composed segment measurement from the global chain: relative SE(2)
    # between consecutive junctions (start-pose independent)
    G = _odo_chain(poses, odo)
    a, b = junctions[:-1], junctions[1:]
    if Kr > 1:
        dth = G[b, 2] - G[a, 2]
        ca, sa = np.cos(G[a, 2]), np.sin(G[a, 2])
        dx, dy = G[b, 0] - G[a, 0], G[b, 1] - G[a, 1]
        red_odo = np.stack([ca * dx + sa * dy, -sa * dx + ca * dy,
                            dth], -1).astype(np.float32)
        red_w = (odo_w / np.maximum(b - a, 1)).astype(np.float32)
    else:
        red_odo = np.zeros((1, 3), np.float32)
        red_w = np.ones(1, np.float32)

    # loop endpoints -> junction indices
    red_li = np.searchsorted(junctions, np.clip(li, 0, K - 1)).astype(np.int32)
    red_lj = np.searchsorted(junctions, np.clip(lj, 0, K - 1)).astype(np.int32)
    red_li = np.clip(red_li, 0, Kr - 1)
    red_lj = np.clip(red_lj, 0, Kr - 1)

    reduced = PoseGraph2D(
        poses=jnp.asarray(poses[junctions]),
        odo_meas=jnp.asarray(red_odo),
        loop_i=jnp.asarray(red_li),
        loop_j=jnp.asarray(red_lj),
        loop_meas=graph.loop_meas,
        loop_valid=graph.loop_valid)
    return reduced, jnp.asarray(red_w), junctions


def expand_reduced(graph: PoseGraph2D, junctions, opt_red) -> np.ndarray:
    """Recover interior chain poses from optimized junction poses
    (vectorized: one pass over all poses).

    Per segment [a..b]: rigid-place the raw odometry chain at the optimized
    pose of a, measure the endpoint discrepancy at b, and distribute it
    along the segment by cumulative path length — rotation interpolated
    about a, the translation residue linearly (exact at both endpoints)."""
    poses = np.asarray(graph.poses)
    odo = np.asarray(graph.odo_meas)
    opt_red = np.asarray(opt_red)
    K = len(poses)
    G = _odo_chain(poses, odo)

    # per-pose segment id (pose k belongs to [junctions[s], junctions[s+1]])
    seg = np.clip(np.searchsorted(junctions, np.arange(K), side="right") - 1,
                  0, len(junctions) - 2)
    ja = junctions[seg]                       # segment start pose index
    jb = junctions[seg + 1]
    pa = opt_red[seg]                         # (K, 3) optimized seg start
    pb = opt_red[seg + 1]

    # chain_k = T(pa) ∘ T(G_a)^-1 ∘ G_k  (rigid placement)
    tha = G[ja, 2]
    ca, sa = np.cos(tha), np.sin(tha)
    rx = G[:, 0] - G[ja, 0]
    ry = G[:, 1] - G[ja, 1]
    rel = np.stack([ca * rx + sa * ry, -sa * rx + ca * ry], -1)
    th_rel = G[:, 2] - tha
    cp, sp = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    chain_xy = pa[:, :2] + np.stack([cp * rel[:, 0] - sp * rel[:, 1],
                                     sp * rel[:, 0] + cp * rel[:, 1]], -1)
    chain_th = pa[:, 2] + th_rel

    # endpoint discrepancy per segment, broadcast back to poses
    chain_xy_b = chain_xy[jb] * 0.0  # placeholder shape
    # chain at each segment END, evaluated with that segment's placement:
    relb = np.stack([ca * (G[jb, 0] - G[ja, 0]) + sa * (G[jb, 1] - G[ja, 1]),
                     -sa * (G[jb, 0] - G[ja, 0]) + ca * (G[jb, 1] - G[ja, 1])],
                    -1)
    chain_xy_b = pa[:, :2] + np.stack(
        [cp * relb[:, 0] - sp * relb[:, 1],
         sp * relb[:, 0] + cp * relb[:, 1]], -1)
    chain_th_b = pa[:, 2] + (G[jb, 2] - tha)
    dth = np.arctan2(np.sin(pb[:, 2] - chain_th_b),
                     np.cos(pb[:, 2] - chain_th_b))

    # cumulative arc-length fraction within the segment
    steps = np.concatenate([[0.0], np.hypot(odo[:, 0], odo[:, 1])])
    cum = np.cumsum(steps)
    f = (cum - cum[ja]) / np.maximum(cum[jb] - cum[ja], 1e-9)

    cf, sf = np.cos(f * dth), np.sin(f * dth)
    relp = chain_xy - pa[:, :2]
    rot = np.stack([cf * relp[:, 0] - sf * relp[:, 1],
                    sf * relp[:, 0] + cf * relp[:, 1]], -1)
    # full-rotation endpoint + translation residue (exact at both ends)
    cfb, sfb = np.cos(dth), np.sin(dth)
    relb_p = chain_xy_b - pa[:, :2]
    end_rot = np.stack([cfb * relb_p[:, 0] - sfb * relb_p[:, 1],
                        sfb * relb_p[:, 0] + cfb * relb_p[:, 1]], -1)
    t_corr = pb[:, :2] - (pa[:, :2] + end_rot)

    out = np.empty((K, 3), np.float32)
    out[:, :2] = pa[:, :2] + rot + f[:, None] * t_corr
    out[:, 2] = chain_th + f * dth
    # junction poses exactly from the reduced solution
    out[junctions] = opt_red
    return out


def optimize_pose_graph_fast(graph: PoseGraph2D, iters: int = 15,
                             odo_w: float = 1.0, lc_w: float = 10.0,
                             damping: float = 1e-3,
                             backend: str = "auto"):
    """Junction-reduced PGO for km-scale sessions.

    backend: "fused" (the default everywhere) = ONE jitted device program
    doing reduction -> reduced GN solve -> interior expansion, with the
    junction set padded to its static bound Kr <= 2 + 2L; "xla" = host-side
    numpy reduction + jitted reduced solve + host expansion.  Equivalence
    with the full dense solve is asserted in tests/test_pgo.py."""
    if backend in ("auto", "fused"):
        return _pgo_fused(graph.poses, graph.odo_meas, graph.loop_i,
                          graph.loop_j, graph.loop_meas, graph.loop_valid,
                          jnp.float32(odo_w), iters, lc_w, damping)
    if backend != "xla":
        raise ValueError(f"unknown PGO backend {backend!r}")
    reduced, red_w, junctions = reduce_pose_graph(graph, odo_w)
    opt_red = _optimize_reduced_jit(reduced, red_w, iters, lc_w, damping)
    return expand_reduced(graph, junctions, opt_red)


@functools.partial(jax.jit, static_argnames=("iters", "lc_w", "damping"))
def _pgo_fused(poses, odo, loop_i, loop_j, loop_meas, loop_valid,
               odo_w, iters, lc_w, damping):
    """Single-program junction-reduced PGO: reduce -> solve -> expand.

    The host path (reduce_pose_graph + solve + expand_reduced) pays 3
    device<->host round trips; this one pays none.  Everything here is
    static-shaped:
    the junction set is padded to Kr = 2 + 2L with copies of K-1, whose
    zero-length / zero-measurement segments (weight odo_w) pin the padded
    poses to the final pose — semantics identical to the unpadded host
    reduction (asserted against it in tests/test_pgo.py)."""
    K = poses.shape[0]

    # junction set: sorted unique {0, K-1, valid loop endpoints}, padded
    # with K-1 (duplicates replaced by K-1, then re-sorted to the tail)
    li = jnp.where(loop_valid, loop_i, K - 1).astype(jnp.int32)
    lj = jnp.where(loop_valid, loop_j, K - 1).astype(jnp.int32)
    ends = jnp.sort(jnp.concatenate(
        [jnp.array([0, K - 1], jnp.int32), li, lj]))
    dup = jnp.concatenate([jnp.array([False]), ends[1:] == ends[:-1]])
    junctions = jnp.sort(jnp.where(dup, K - 1, ends))        # (Kr,)
    Kr = junctions.shape[0]

    # global odometry chain G[k] = T(poses[0]) . m_0 ... m_{k-1}
    th = jnp.concatenate([poses[0:1, 2], poses[0, 2] + jnp.cumsum(odo[:, 2])])
    c, s = jnp.cos(th[:-1]), jnp.sin(th[:-1])
    steps = jnp.stack([c * odo[:, 0] - s * odo[:, 1],
                       s * odo[:, 0] + c * odo[:, 1]], -1)
    Gxy = jnp.concatenate([poses[0:1, :2],
                           poses[0, :2] + jnp.cumsum(steps, axis=0)])
    G = jnp.column_stack([Gxy, th])

    # composed segment measurements between consecutive junctions
    a, b = junctions[:-1], junctions[1:]
    dth_seg = G[b, 2] - G[a, 2]
    ca, sa = jnp.cos(G[a, 2]), jnp.sin(G[a, 2])
    dxy = G[b, :2] - G[a, :2]
    red_odo = jnp.stack([ca * dxy[:, 0] + sa * dxy[:, 1],
                         -sa * dxy[:, 0] + ca * dxy[:, 1], dth_seg], -1)
    red_w = odo_w / jnp.maximum(b - a, 1).astype(jnp.float32)

    red_li = jnp.clip(jnp.searchsorted(junctions, li), 0, Kr - 1)
    red_lj = jnp.clip(jnp.searchsorted(junctions, lj), 0, Kr - 1)
    reduced = PoseGraph2D(poses=poses[junctions], odo_meas=red_odo,
                          loop_i=red_li, loop_j=red_lj,
                          loop_meas=loop_meas, loop_valid=loop_valid)
    opt_red = optimize_pose_graph(reduced, iters=iters, odo_w=red_w,
                                  lc_w=lc_w, damping=damping)

    # interior expansion: rigid-place each segment's raw chain at the
    # optimized start pose, distribute the endpoint discrepancy by
    # cumulative arc length (exact at both endpoints)
    seg = jnp.clip(jnp.searchsorted(junctions, jnp.arange(K), side="right")
                   - 1, 0, Kr - 2)
    ja, jb = junctions[seg], junctions[seg + 1]
    pa, pb = opt_red[seg], opt_red[seg + 1]

    tha = G[ja, 2]
    ca, sa = jnp.cos(tha), jnp.sin(tha)
    rx, ry = G[:, 0] - G[ja, 0], G[:, 1] - G[ja, 1]
    rel = jnp.stack([ca * rx + sa * ry, -sa * rx + ca * ry], -1)
    th_rel = G[:, 2] - tha
    cp, sp = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    chain_xy = pa[:, :2] + jnp.stack(
        [cp * rel[:, 0] - sp * rel[:, 1],
         sp * rel[:, 0] + cp * rel[:, 1]], -1)
    chain_th = pa[:, 2] + th_rel

    relb = jnp.stack(
        [ca * (G[jb, 0] - G[ja, 0]) + sa * (G[jb, 1] - G[ja, 1]),
         -sa * (G[jb, 0] - G[ja, 0]) + ca * (G[jb, 1] - G[ja, 1])], -1)
    chain_xy_b = pa[:, :2] + jnp.stack(
        [cp * relb[:, 0] - sp * relb[:, 1],
         sp * relb[:, 0] + cp * relb[:, 1]], -1)
    chain_th_b = pa[:, 2] + (G[jb, 2] - tha)
    dth = jnp.arctan2(jnp.sin(pb[:, 2] - chain_th_b),
                      jnp.cos(pb[:, 2] - chain_th_b))

    steps_len = jnp.concatenate([jnp.zeros(1),
                                 jnp.hypot(odo[:, 0], odo[:, 1])])
    cum = jnp.cumsum(steps_len)
    f = (cum - cum[ja]) / jnp.maximum(cum[jb] - cum[ja], 1e-9)

    cf, sf = jnp.cos(f * dth), jnp.sin(f * dth)
    relp = chain_xy - pa[:, :2]
    rot = jnp.stack([cf * relp[:, 0] - sf * relp[:, 1],
                     sf * relp[:, 0] + cf * relp[:, 1]], -1)
    cfb, sfb = jnp.cos(dth), jnp.sin(dth)
    relb_p = chain_xy_b - pa[:, :2]
    end_rot = jnp.stack([cfb * relb_p[:, 0] - sfb * relb_p[:, 1],
                         sfb * relb_p[:, 0] + cfb * relb_p[:, 1]], -1)
    t_corr = pb[:, :2] - (pa[:, :2] + end_rot)

    out_xy = pa[:, :2] + rot + f[:, None] * t_corr
    out_th = chain_th + f * dth
    out = jnp.column_stack([out_xy, out_th])
    return out.at[junctions].set(opt_red)


@functools.partial(jax.jit, static_argnames=("iters", "lc_w", "damping"))
def _optimize_reduced_jit(graph, odo_w, iters, lc_w, damping):
    return optimize_pose_graph(graph, iters=iters, odo_w=odo_w, lc_w=lc_w,
                               damping=damping)

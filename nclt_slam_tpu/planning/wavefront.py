"""Jitted wavefront global planner — the NavFn/A* equivalent.

The reference calls Nav2's C++ NavFn planner over a 0.1 m costmap
(nav2_planner_defaults.yaml: use_astar, tolerance 1.0).  A heap-ordered A*
does not batch, so we compute the full potential field by iterated
8-neighbor min-plus relaxation over a fixed local window (Bellman-Ford /
value-iteration — each sweep is a handful of shifts + mins on the whole
window), then extract the path by steepest descent.  This is exactly
NavFn's potential-propagation formulation, just parallel-in-space instead
of queue-ordered.

The relaxation (``relax``) runs as one CUDA kernel launch on NVIDIA GPUs
(ops/wavefront.cu) and as an XLA ``fori_loop`` (``relax_xla``) elsewhere;
both compute the same f32 sums and mins in the same order.

Costs enter the traversal metric the NavFn way: step_cost = dist * (1 +
w * cell_cost), lethal cells (>= 99) are impassable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nclt_slam_tpu.config import MapConfig, PlannerConfig
from nclt_slam_tpu.ops.wavefront_cuda import relax_cuda

BIG = jnp.float32(1e9)
DIAG = 1.4142135


class PlanResult(NamedTuple):
    path_xy: jax.Array     # (path_len, 2) world coords (padded with last)
    n_path: jax.Array      # () int32 — valid prefix length
    ok: jax.Array          # () bool — goal potential is finite at start
    potential: jax.Array   # (window, window) — for debugging/analysis


def _neighbor_min(phi, tc, diag_scale):
    """One relaxation sweep: phi <- min over 8 neighbors of phi_n + cost."""

    def shift(a, dr, dc):
        a = jnp.roll(a, dr, 0)
        a = jnp.roll(a, dc, 1)
        # roll wraps; poison the wrapped edge
        if dr == 1:
            a = a.at[0, :].set(BIG)
        elif dr == -1:
            a = a.at[-1, :].set(BIG)
        if dc == 1:
            a = a.at[:, 0].set(BIG)
        elif dc == -1:
            a = a.at[:, -1].set(BIG)
        return a

    best = phi
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        best = jnp.minimum(best, shift(phi, dr, dc) + tc)
    tcd = tc * diag_scale
    for dr, dc in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        best = jnp.minimum(best, shift(phi, dr, dc) + tcd)
    return best


def relax_xla(tc, phi0, n_iter: int):
    """``n_iter`` Jacobi sweeps of the 8-neighbor min-plus update (the
    reference implementation; a fixed trip count, no convergence check)."""

    def body(_, phi):
        return jnp.minimum(phi, _neighbor_min(phi, tc, DIAG))

    return jax.lax.fori_loop(0, n_iter, body, phi0)


def relax(tc, phi0, n_iter: int):
    """``relax_xla`` on every platform but CUDA, where the whole relaxation
    is one kernel launch that keeps the potential in shared memory."""
    return jax.lax.platform_dependent(
        tc, phi0,
        cuda=lambda t, p: relax_cuda(t, p, n_iter),
        default=lambda t, p: relax_xla(t, p, n_iter))


def plan_window(cost, start_rc, goal_rc, map_cfg: MapConfig,
                cfg: PlannerConfig, border_phi=None) -> PlanResult:
    """Plan inside a (window, window) cost crop.

    start_rc/goal_rc are (row, col) cell coords *within the window* (goal
    clamped into it by the caller).  ``border_phi`` (W, W), when given,
    seeds the relaxation with cost-to-goal values on the window BORDER
    (BIG elsewhere) — the two-level planner's coarse full-map potential,
    which lets the window route toward bypasses longer than the window
    itself (the reference's NavFn plans on the whole teach costmap).
    Returns the path in window cell space converted to metric offsets by
    the caller.
    """
    W = cfg.window
    res = map_cfg.resolution

    # per-cell traversal cost factor; lethal cells unreachable
    lethal = cost >= cfg.lethal_cost
    tc = res * (1.0 + cfg.cost_weight * cost)
    tc = jnp.where(lethal, BIG, tc)

    gr, gc = goal_rc
    phi0 = jnp.full((W, W), BIG).at[gr, gc].set(0.0)
    if border_phi is not None:
        phi0 = jnp.minimum(phi0, border_phi)

    # each Jacobi sweep propagates one ring
    phi = relax(tc, phi0, cfg.sweeps * W)

    sr, sc = start_rc
    ok = phi[sr, sc] < BIG

    # descent extraction from the start cell.  The Bellman equation is
    # phi[x] = min_n (scale(n) * tc[x] + phi[n]), so the optimal next cell
    # minimizes phi[n] + scale(n) * tc[x] — descending on raw phi[n]
    # ignores the 1.41x diagonal surcharge and over-selects diagonals
    # through inflation zones (caught by the full-grid oracle test: 24 %
    # path-cost excess on walled detour legs).
    offs = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
            if (dr, dc) != (0, 0)]
    rr = jnp.asarray(offs, jnp.int32)
    step_scale = jnp.asarray(
        [DIAG if (dr and dc) else 1.0 for dr, dc in offs], jnp.float32)

    def step(carry, _):
        r, c, done = carry
        nr = jnp.clip(r + rr[:, 0], 0, W - 1)
        nc = jnp.clip(c + rr[:, 1], 0, W - 1)
        vals = phi[nr, nc] + step_scale * tc[r, c]
        k = jnp.argmin(vals)
        r2, c2 = nr[k], nc[k]
        at_goal = (r2 == gr) & (c2 == gc)
        # border-clipped neighbors can alias the current cell
        stuck = ((r2 == r) & (c2 == c)) | (phi[r2, c2] >= phi[r, c])
        r3 = jnp.where(done, r, r2)
        c3 = jnp.where(done, c, c2)
        return (r3, c3, done | at_goal | stuck), (r3, c3, ~done)

    (_, _, _), (pr, pc, live) = jax.lax.scan(
        step, (sr, sc, ~ok), None, length=cfg.path_len)
    n_path = live.sum().astype(jnp.int32)
    path_rc = jnp.stack([pr, pc], -1).astype(jnp.float32)
    return PlanResult(path_xy=path_rc, n_path=n_path, ok=ok, potential=phi)


def coarse_traversal(teach_grid, map_cfg: MapConfig, cfg: PlannerConfig):
    """Static full-map traversal-cost field at ``coarse_factor`` x coarser
    resolution (two-level planning, level 1).  Occupied coarse cells are
    lethal; a one-cell dilation stands in for the inflation layer."""
    f = cfg.coarse_factor
    occ = teach_grid == 2
    rows, cols = occ.shape
    Rp = -(-rows // f) * f
    Cp = -(-cols // f) * f
    occ = jnp.pad(occ, ((0, Rp - rows), (0, Cp - cols)))
    occ8 = occ.reshape(Rp // f, f, Cp // f, f).any(axis=(1, 3))
    near = occ8
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        near = near | jnp.roll(occ8, (dr, dc), (0, 1))
    cost = jnp.where(occ8, 100.0, jnp.where(near, 50.0, 0.0))
    tc = (f * map_cfg.resolution) * (1.0 + cfg.cost_weight * cost)
    return jnp.where(occ8, BIG, tc).astype(jnp.float32)


def coarse_potential(tc_coarse, goal_xy, map_cfg: MapConfig,
                     cfg: PlannerConfig):
    """Full-map cost-to-goal potential on the coarse grid (level-1 plan)."""
    Rc, Cc = tc_coarse.shape
    f = cfg.coarse_factor
    res_c = f * map_cfg.resolution
    gc = jnp.clip((goal_xy[0] - map_cfg.origin_x) / res_c,
                  0, Cc - 1).astype(jnp.int32)
    gr = jnp.clip((goal_xy[1] - map_cfg.origin_y) / res_c,
                  0, Rc - 1).astype(jnp.int32)
    phi0 = jnp.full((Rc, Cc), BIG).at[gr, gc].set(0.0)
    return relax_xla(tc_coarse, phi0, cfg.coarse_iters)


def _border_seed(coarse_phi, win_r0, win_c0, map_cfg: MapConfig,
                 cfg: PlannerConfig):
    """(W, W) seed: coarse cost-to-goal sampled on the window border ring,
    BIG elsewhere."""
    W = cfg.window
    f = cfg.coarse_factor
    Rc, Cc = coarse_phi.shape
    rows = jnp.arange(W)
    rr = ((rows + win_r0) // f).clip(0, Rc - 1)
    cc = ((rows + win_c0) // f).clip(0, Cc - 1)
    vals = coarse_phi[rr[:, None], cc[None, :]]          # (W, W)
    border = (jnp.arange(W)[:, None] % (W - 1) == 0) | \
        (jnp.arange(W)[None, :] % (W - 1) == 0)
    return jnp.where(border, vals, BIG)


def plan_world(cost_window, win_r0, win_c0, start_xy, goal_xy,
               map_cfg: MapConfig, cfg: PlannerConfig,
               coarse_phi=None, coarse_goal=None) -> PlanResult:
    """Wrapper taking world coords; clamps the goal into the window (like
    Nav2 planning to the costmap edge toward an out-of-window goal).

    ``coarse_phi``/``coarse_goal``: level-1 full-map potential + the goal
    it was computed for.  The border seed is applied only while the
    current goal matches the potential's goal (within 2 m) — a stale
    potential (target just changed) falls back to pure window planning.
    """
    W = cfg.window
    res = map_cfg.resolution

    def to_win(xy):
        c = (xy[0] - map_cfg.origin_x) / res - win_c0
        r = (xy[1] - map_cfg.origin_y) / res - win_r0
        return (jnp.clip(r, 0, W - 1).astype(jnp.int32),
                jnp.clip(c, 0, W - 1).astype(jnp.int32))

    start_rc = to_win(start_xy)
    goal_rc = to_win(goal_xy)
    border_phi = None
    if coarse_phi is not None:
        seed = _border_seed(coarse_phi, win_r0, win_c0, map_cfg, cfg)
        fresh = jnp.linalg.norm(goal_xy - coarse_goal) < 2.0
        border_phi = jnp.where(fresh, seed, BIG)
    res_plan = plan_window(cost_window, start_rc, goal_rc, map_cfg, cfg,
                           border_phi=border_phi)

    # window cells -> world coords
    wx = map_cfg.origin_x + (res_plan.path_xy[:, 1] + win_c0 + 0.5) * res
    wy = map_cfg.origin_y + (res_plan.path_xy[:, 0] + win_r0 + 0.5) * res
    path_world = jnp.stack([wx, wy], -1)
    # pad the tail with the last valid point
    idx = jnp.minimum(jnp.arange(cfg.path_len), jnp.maximum(res_plan.n_path - 1, 0))
    path_world = path_world[idx]
    return PlanResult(path_xy=path_world, n_path=res_plan.n_path,
                      ok=res_plan.ok, potential=res_plan.potential)

"""Tracing / profiling utilities (SURVEY.md §5).

The reference's observability is throttled log lines + a startup topic-Hz
check (run_husky_forest.py:615-624).  Here: a steps/sec rate counter for
rollout loops, a ``jax.profiler`` trace context for device timeline captures,
and structured rollout statistics extracted from traces (the single
trace-array-per-rollout design replacing the reference's 8 log files).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


class RateCounter:
    """Steps/sec counter with periodic throttled reporting."""

    def __init__(self, name: str = "steps", report_every: float = 5.0):
        self.name = name
        self.report_every = report_every
        self.t0 = time.perf_counter()
        self.last_report = self.t0
        self.count = 0

    def add(self, n: int = 1, log=print):
        self.count += n
        now = time.perf_counter()
        if now - self.last_report >= self.report_every:
            rate = self.count / (now - self.t0)
            log(f"[{self.name}] {self.count} total, {rate:.1f}/s")
            self.last_report = now

    @property
    def rate(self) -> float:
        return self.count / max(time.perf_counter() - self.t0, 1e-9)


@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/jax_trace"):
    """Capture a jax.profiler trace (view with TensorBoard/xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def rollout_stats(trace) -> dict:
    """Structured statistics from a RepeatTrace — the machine-readable
    replacement for grepping tf_slam.log / pp_follower.log / goals.log."""
    gt = np.asarray(trace.gt_xy)
    nav = np.asarray(trace.nav_xy)
    regime = np.asarray(trace.regime)
    stats = {
        "ticks": int(gt.shape[-2]),
        "path_m": float(np.hypot(*np.diff(gt, axis=-2).T).sum()),
        "drift_mean_m": float(np.hypot(*(nav - gt).T).mean()),
        "drift_max_m": float(np.hypot(*(nav - gt).T).max()),
        "anchors_published": int(np.asarray(trace.anchor_ok).sum()),
        "fired": bool(np.asarray(trace.fired).any()),
        "done": bool(np.asarray(trace.done).any()),
    }
    live = regime[regime >= 0]
    if live.size:
        counts = np.bincount(live, minlength=4)
        stats["regime_counts"] = {
            "no_anchor": int(counts[0]), "ok": int(counts[1]),
            "strong": int(counts[2]), "encoder": int(counts[3]),
        }
    if hasattr(trace, "vio_tracked"):
        tr = np.asarray(trace.vio_tracked)
        tr = tr[tr >= 0]
        if tr.size:
            stats["vio_tracked_mean"] = float(tr.mean())
    return stats

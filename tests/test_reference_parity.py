"""Behavior-statistics parity against the reference's logged outcomes.

The reference's only recorded behavioral trace is the anchor-attempt log
``anchor_matches.csv`` (written by visual_landmark_matcher.py:224-279; the
surviving copy lives in experiments/76_rgbd_no_imu_ours/results/run_09).
SURVEY hard part #3 requires validating our match/inlier/false-match
statistics against its outcome distribution.  Three layers:

1. oracle integrity: parse the reference CSV and pin the derived stats
   (fractions, shift quantiles, inlier mean) that tools/calibrate.py and
   the artifact test use — if the constants drift from the CSV, this fails.
2. artifact parity: the committed calibration artifact
   (artifacts/calibration/ours.json, produced by ``python tools/calibrate.py
   --routes ... --json ...`` on the earlier accelerator) must match the reference
   distribution within tolerance.
3. live distribution sanity (slow): a short CPU campaign must produce all
   outcome families in reference-like proportions.
"""

from __future__ import annotations

import collections
import csv
import json
import re
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
REF_CSV = Path("/root/reference/simulation/isaac/experiments/"
               "76_rgbd_no_imu_ours/results/run_09/anchor_matches.csv")
ARTIFACT = REPO / "artifacts" / "calibration" / "ours.json"

# derived from REF_CSV (680 attempts); test_reference_csv_parse pins these
REF_FRAC = {"published": 0.381, "no_pnp_accept": 0.450,
            "no_candidates": 0.128, "consistency_fail": 0.041}
REF_SHIFT_MEDIAN = 1.2
REF_SHIFT_P90 = 3.3
REF_INLIERS_MEAN = 31.8


def parse_reference_csv(path=REF_CSV):
    rows = list(csv.DictReader(open(path)))
    fam = collections.Counter()
    shifts, inliers = [], []
    for r in rows:
        o = r["outcome"]
        if o.startswith("published"):
            fam["published"] += 1
            m = re.search(r"shift([0-9.]+)", o)
            if m:
                shifts.append(float(m.group(1)))
            inliers.append(int(r["best_n_inliers"]))
        elif o.startswith("consistency_fail"):
            fam["consistency_fail"] += 1
        else:
            fam[o] += 1
    n = len(rows)
    return ({k: v / n for k, v in fam.items()}, np.asarray(shifts),
            np.asarray(inliers), n)


@pytest.mark.skipif(not REF_CSV.exists(), reason="reference CSV not present")
def test_reference_csv_parse():
    """The oracle constants must equal what the CSV actually contains."""
    frac, shifts, inliers, n = parse_reference_csv()
    assert n == 680
    for k, v in REF_FRAC.items():
        assert abs(frac.get(k, 0.0) - v) < 0.005, (k, frac.get(k))
    assert abs(np.median(shifts) - REF_SHIFT_MEDIAN) < 0.05
    assert abs(np.percentile(shifts, 90) - REF_SHIFT_P90) < 0.15
    assert abs(inliers.mean() - REF_INLIERS_MEAN) < 0.5


@pytest.mark.skipif(not ARTIFACT.exists(),
                    reason="calibration artifact not generated yet")
def test_calibration_artifact_distribution():
    """The committed calibration run must land inside the reference's
    outcome-distribution bands (the 'distribution tests green' criterion of
    the behavior-calibration milestone)."""
    d = json.loads(ARTIFACT.read_text())
    anchor = d["anchor"]
    tot = sum(a["attempts"] for a in anchor.values())
    assert tot > 1000, "artifact too small to be a real calibration run"
    frac = collections.Counter()
    for a in anchor.values():
        for k, v in a["frac"].items():
            frac[k] += v * a["attempts"] / tot

    # outcome-family fractions within absolute bands of the reference
    assert abs(frac.get("published", 0) - REF_FRAC["published"]) < 0.12
    assert abs(frac.get("no_pnp_accept", 0)
               - REF_FRAC["no_pnp_accept"]) < 0.15
    assert frac.get("no_candidates", 0) < 0.30

    # publish-shift spread: same order of magnitude as the reference's
    # (fused error at anchor time — the inter-anchor drift signature)
    med = np.mean([a["shift_median"] for a in anchor.values()
                   if a["attempts"]])
    assert 0.15 < med < 3.0, med

    # teach drift must land at or below the reference's per-route band
    # (routes/README.md:24-40: means 0.34-0.65 m, max <= 1.18 m).  The r5
    # pointing-bias retune (0.25 px/20 m — required to pull route 05 from
    # 2.11 m back under the 1.2 m bound) leaves short multi-leg routes at
    # ~0.05-0.15 m, below the reference floor: the error model lacks a
    # geometry-independent drift source (documented residual, RESULTS r5).
    td = [v[0] for v in d["teach_drift"].values()]
    assert 0.1 < float(np.mean(td)) < 1.1, td


@pytest.mark.slow
def test_live_outcome_families():
    """Short CPU campaign: every outcome family the reference logs must
    occur, with published somewhere in the plausible band."""
    import jax

    from nclt_slam_tpu import config
    from nclt_slam_tpu.rollout.campaign import (
        build_campaign, run_campaign_repeat, run_campaign_teach,
        teach_waypoints)

    cfg = config.ours()
    data = build_campaign(["08_nw_sw"], cfg=cfg)
    teach = run_campaign_teach(data, cfg, n_ticks=1800)
    wps, n_wps = teach_waypoints(data, teach, cfg)
    rep = run_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg,
                              n_ticks=1800, stores=teach.store)
    reasons = np.asarray(rep.trace.anchor_reason)[0]
    att = reasons[reasons >= 0]
    assert len(att) > 100
    frac = collections.Counter(att.tolist())
    published = frac.get(0, 0) / len(att)
    no_pnp = frac.get(3, 0) / len(att)
    assert 0.10 < published < 0.75, published
    assert no_pnp > 0.10, no_pnp

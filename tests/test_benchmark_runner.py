"""Dataset benchmark runner (cli/benchmark.py): the RobotCar/4Seasons
end-to-end equivalent of run_full_benchmark.py — session synthesis, VIO
tracking in the dataset's sensor mode, EuRoC/TUM export, ATE table."""

import json

import numpy as np
import pytest

from nclt_slam_tpu.cli.benchmark import (
    _condition_windows,
    _loop_route,
    run_dataset,
)

pytestmark = pytest.mark.slow


def test_loop_route_closed_and_spaced():
    rng = np.random.default_rng(0)
    r = _loop_route(400.0, rng)
    seg = np.linalg.norm(np.diff(r, axis=0), axis=1)
    # spacing stays in a sane band and the loop closes
    assert 0.1 < seg.mean() < 1.0
    assert np.linalg.norm(r[0] - r[-1]) < 3.0
    total = seg.sum()
    assert 250.0 < total < 650.0


def test_condition_windows_cover_requested_fraction():
    rng = np.random.default_rng(1)
    ck = _condition_windows(10000, rng, 5, frac_lo=0.04, frac_hi=0.09,
                            keep=0.03)
    frac = (ck < 1.0).mean()
    assert 0.10 < frac < 0.50
    assert ck.min() == np.float32(0.03)


def test_run_dataset_4seasons_tiny(tmp_path):
    """End-to-end on a tiny tick budget: table + JSON + EuRoC tree exist,
    VI mode tracks the benign session."""
    payload = run_dataset("4seasons", tmp_path, n_ticks=400,
                          export=True, seed=5)
    rows = payload["rows"]
    assert set(rows) == {"spring", "autumn"}
    assert rows["spring"]["tracked_pct"] > 90.0
    assert rows["spring"]["ate_rmse_m"] < 2.0
    d = json.load(open(tmp_path / "4seasons_bench.json"))
    assert d["reference"]["ate_rmse_m"] == 0.93
    assert (tmp_path / "4seasons_spring" / "mav0" / "imu0"
            / "data.csv").exists()
    assert (tmp_path / "4seasons_spring" / "est_tum.txt").exists()


def test_run_dataset_robotcar_ins_imu(tmp_path):
    """RobotCar path synthesizes the INS pseudo-IMU; its yaw-rate stream
    must correlate with the simulated Phidgets gyro (frame sanity)."""
    payload = run_dataset("robotcar", tmp_path, n_ticks=400,
                          export=True, seed=6)
    for row in payload["rows"].values():
        assert row["ins_imu_gyro_corr"] > 0.9

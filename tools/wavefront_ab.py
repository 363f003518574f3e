#!/usr/bin/env python3
"""Repeat-tick time with the CUDA wavefront kernel against the XLA loop.

    python tools/wavefront_ab.py [--routes 15] [--ticks 250] [--rounds 2]

Builds the campaign, teaches (gt), warms the ours-mode repeat, then times
the same repeat window from the same warm carry with the planner's
relaxation as the CUDA kernel (K) and as the XLA ``fori_loop`` (X), in the
order K X X K per round, in one process on one card.  The planner picks
the kernel by platform; this tool swaps ``planning.wavefront.relax`` only
while each variant is traced.  Prints the card, every window's time, and
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", type=int, default=15)
    ap.add_argument("--ticks", type=int, default=250)
    ap.add_argument("--teach-ticks", type=int, default=1500)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    from nclt_slam_tpu.runtime import init_runtime

    init_runtime()
    import jax
    import numpy as np

    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.planning import wavefront
    from nclt_slam_tpu.rollout import campaign
    from nclt_slam_tpu.scene.routes import ALL_ROUTES

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU, found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)

    names = ALL_ROUTES[:args.routes]
    cfg = cfg_mod.ours()
    data = campaign.build_campaign(names, cfg=cfg)
    teach = campaign.run_campaign_teach(data, cfg_mod.gt_localization(),
                                        args.teach_ticks)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)

    def window(carry, tick0):
        out = campaign.run_campaign_repeat(
            data, teach.teach_grid, wps, n_wps, cfg, args.ticks,
            stores=teach.store, carry=carry, tick0=tick0,
            stop_when_done=False, chunk=args.ticks)
        jax.block_until_ready(out.final.robot.xy)
        return out

    warm = window(None, 0)
    key = ("repeat", cfg, args.ticks)
    variants = {
        "kernel": wavefront.relax,
        "xla": lambda tc, phi0, n_iter: wavefront.relax_xla(tc, phi0, n_iter),
    }
    programs, compile_s = {}, {}
    for name, relax in variants.items():
        wavefront.relax = relax
        campaign._JIT_CACHE.pop(key, None)
        t0 = time.perf_counter()
        window(warm.final, args.ticks)           # traces this variant
        compile_s[name] = time.perf_counter() - t0
        programs[name] = campaign._JIT_CACHE[key]
    wavefront.relax = variants["kernel"]

    times = {name: [] for name in variants}
    finals = {}
    for _ in range(args.rounds):
        for name in ("kernel", "xla", "xla", "kernel"):
            campaign._JIT_CACHE[key] = programs[name]
            t0 = time.perf_counter()
            out = window(warm.final, args.ticks)
            dt = time.perf_counter() - t0
            times[name].append(dt)
            finals[name] = np.asarray(out.trace.gt_xy)
            print(f"{name}: {args.ticks} ticks in {dt:.4f} s", flush=True)
    med = {k: float(np.median(v)) for k, v in times.items()}
    same = bool(np.array_equal(finals["kernel"], finals["xla"]))
    print(json.dumps({
        "card": card.strip(), "routes": len(names), "ticks": args.ticks,
        "window_s": times, "median_s": med,
        "ms_per_tick": {k: 1e3 * v / args.ticks for k, v in med.items()},
        "first_call_s": compile_s,
        "kernel_faster": med["kernel"] < med["xla"],
        "traces_identical": same,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()

#!/bin/bash
# phase-split campaign with process-level retry (a failed phase reruns
# in a fresh process, which recompiles cleanly)
OUT=${1:-/root/repo/artifacts/campaign_final}
LOG=$OUT.log
cd /root/repo
for i in 1 2 3; do
  python -m nclt_slam_tpu.cli.campaign --routes all --mode ours --out $OUT \
    --teach-ticks 9000 --phase teach >> $LOG 2>&1 && break
  echo "[retry] teach attempt $i failed" >> $LOG
done
for i in 1 2 3 4; do
  python -m nclt_slam_tpu.cli.campaign --routes all --mode ours --out $OUT \
    --repeat-ticks 12000 --phase repeat --figures >> $LOG 2>&1 && exit 0
  echo "[retry] repeat attempt $i failed" >> $LOG
done
exit 1

#!/bin/bash
# Behavioral acceptance gate of the PyTorch + CUDA port (reference
# scripts/utils/behavior_tests.sh:4-17 runs toybox.sample_tests.* as
# unittests against saved ppo2 models).
#
# Default: gate EVERY committed model family (the port's families.py
# registry: ppo/ppo1/a2c/acer/acktr/trpo/deepq/gail/bc) through every
# white-box scenario, each with its calibrated or explicitly-waived
# checks; exit nonzero if any gated family regresses. FAMILIES="ppo1 a2c"
# narrows the set.
#
# SMOKE=1: cheap per-frame random-policy smoke instead (always exit 0
# unless the harness itself breaks). MAX_FRAMES/EPISODES cap the budget.
# Runs on the GPU; DEVICE=cpu runs it on the CPU.
set -e
cd "$(dirname "$0")/.."
DEVICE=${DEVICE:-cuda}
FAMILIES=${FAMILIES:-"ppo ppo1 a2c acer acktr trpo deepq gail bc"}
ARGS=(--device "$DEVICE")
[ -n "$MAX_FRAMES" ] && ARGS+=(--max-frames "$MAX_FRAMES")
[ -n "$EPISODES" ] && ARGS+=(--episodes "$EPISODES")

rc=0
for game in breakout amidar space_invaders; do
  if [ -n "${SMOKE:-}" ]; then
    echo "== $game: smoke (random policy) =="
    python3 -m toybox_tpu_torch.sample_tests "$game" \
      --episodes "${EPISODES:-2}" --device "$DEVICE" \
      ${MAX_FRAMES:+--max-frames "$MAX_FRAMES"}
    continue
  fi
  for family in $FAMILIES; do
    echo "== $game: gating family $family =="
    if ! python3 -m toybox_tpu_torch.sample_tests "$game" \
        --family="$family" "${ARGS[@]}"; then
      rc=1
    fi
  done
done
exit $rc

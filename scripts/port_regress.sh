#!/bin/bash
# ppo regression gate of the PyTorch + CUDA port on all 3 games (reference
# scripts/utils/regress.sh). DEVICE=cpu runs it on the CPU.
set -e
cd "$(dirname "$0")/.."
MODELS=${MODELS:-models}
for game in Breakout Amidar SpaceInvaders; do
  python3 -m toybox_tpu_torch.regress --env="${game}ToyboxNoFrameskip-v4" \
    --load_path="$MODELS/$game.regress.model" --threshold "${THRESHOLD:-50}" \
    --device "${DEVICE:-cuda}"
done

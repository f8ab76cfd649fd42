#!/bin/bash
# FPS benchmarks of the PyTorch + CUDA port on one GPU: the headline JSON
# line (bench_torch.py) per game, then the FPS harness. DEVICE=cpu runs
# them on the CPU.
set -e
cd "$(dirname "$0")/.."
DEVICE=${DEVICE:-cuda}
for game in breakout amidar space_invaders; do
  python3 bench_torch.py "$game" "${NENVS:-8192}" --device "$DEVICE"
done
python3 -m toybox_tpu_torch.benchmark --game breakout --device "$DEVICE"

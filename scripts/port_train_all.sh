#!/bin/bash
# Experiment sweep of the PyTorch + CUDA port (reference
# scripts/utils/baselines_scripts/run.sh): algs x games x seeds.
# TOYBOX_LOG_FORMAT=csv mirrors OPENAI_FORMAT=csv. DEVICE=cpu trains on
# the CPU.
set -e
cd "$(dirname "$0")/.."
ALGS=${ALGS:-"ppo a2c deepq acer acktr"}
GAMES=${GAMES:-"Breakout Amidar SpaceInvaders"}
SEEDS=${SEEDS:-"0 1 2"}
STEPS=${STEPS:-1e7}
NENVS=${NENVS:-256}
OUT=${OUT:-runs}
export TOYBOX_LOG_FORMAT=${TOYBOX_LOG_FORMAT:-csv,stdout}
for alg in $ALGS; do
  for game in $GAMES; do
    for seed in $SEEDS; do
      logdir="$OUT/${alg}_${game}_s${seed}"
      echo "=== $alg $game seed=$seed -> $logdir"
      python3 -m toybox_tpu_torch.run --alg="$alg" \
        --env="${game}ToyboxNoFrameskip-v4" --seed="$seed" \
        --num_timesteps="$STEPS" --num_envs="$NENVS" \
        --log_path="$logdir" --device="${DEVICE:-cuda}" \
        --save_path="$logdir/model.msgpack"
    done
  done
done

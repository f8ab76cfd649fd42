"""Steady-state PPO train_step timing of the PyTorch + CUDA port on one
GPU, the counterpart of scripts/ppo_step_timing.py.

    python3 scripts/port_ppo_step_timing.py [game] [n_envs] [variant] \
        [--device cuda|cpu]

variant: f32 (default) | bf16 (network_kwargs dtype bfloat16) | im2col
(network cnn_im2col) | coutpad (network cnn_coutpad) | mbK (K
microbatches a minibatch).

One warm-up update, then UPDATES (6) timed ones, each to a
``torch.cuda.synchronize()``: per-update wall time and frames/s, then the
best update's model FLOPs (bench_torch's count) with its MFU against the
card's bf16 tensor-core peak and its f32 peak outside the tensor cores.
The last line is one JSON object of the same figures and the card's name
and power limit (nvidia-smi). TF32 is off, as at every entry point of the
port. Runs on ``cuda`` unless given ``--device cpu``; with no card it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import (TRAIN_NSTEPS, build_train,  # noqa: E402
                         timed_update, train_rates)
from toybox_tpu_torch.benchmark import device_line, require_device  # noqa: E402

VARIANTS = ("f32", "bf16", "im2col", "coutpad", "mbK")
UPDATES = 6     # timed updates after the warm-up one


def variant_kwargs(variant: str) -> dict:
    """make_ppo's keyword arguments for a variant."""
    if variant == "f32":
        return {}
    if variant == "bf16":
        return {"network_kwargs": {"dtype": "bfloat16"}}
    if variant in ("im2col", "coutpad"):
        return {"network": f"cnn_{variant}"}
    if variant.startswith("mb") and variant[2:].isdigit():
        return {"microbatches": int(variant[2:])}
    raise ValueError(f"unknown variant {variant!r}; have {', '.join(VARIANTS)}")


def time_updates(game: str = "breakout", n_envs: int = 1024,
                 variant: str = "f32", device="cuda") -> dict:
    """Time UPDATES train_steps after one warm-up, printing each;
    returns the summary (the JSON line's figures)."""
    dev = require_device(device)
    env, state, train_step, flops = build_train(game, n_envs, dev,
                                                **variant_kwargs(variant))
    state, warm = timed_update(train_step, state, dev)
    frames = n_envs * TRAIN_NSTEPS * env.frames_per_step
    times = []
    for i in range(UPDATES):
        state, dt = timed_update(train_step, state, dev)
        times.append(dt)
        print(f"update {i}: {dt * 1e3:7.1f} ms  {frames / dt / 1e3:7.1f}k f/s",
              flush=True)
    best = min(times)
    rates = train_rates(frames, flops, best, dev)
    line = f"best: {best * 1e3:.1f} ms  {frames / best / 1e3:.1f}k f/s"
    if "train_tflops_per_s" in rates:
        line += (f"  | {flops / 1e12:.2f} TFLOP/update, "
                 f"{rates['train_tflops_per_s']:.2f} TFLOP/s")
    if "train_mfu_bf16_peak" in rates:
        line += (f", MFU {100 * rates['train_mfu_bf16_peak']:.2f}% of the "
                 f"bf16 peak ({100 * rates['train_mfu_f32_peak']:.2f}% of "
                 f"the f32 peak)")
    print(f"[{variant}] {line}", flush=True)
    return {"game": game, "n_envs": n_envs, "variant": variant,
            "warmup_ms": warm * 1e3, "update_ms": [t * 1e3 for t in times],
            "best_ms": best * 1e3, "flops_per_update": flops, **rates,
            "device": device_line(dev)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("game", nargs="?", default="breakout")
    p.add_argument("n_envs", nargs="?", type=int, default=1024)
    p.add_argument("variant", nargs="?", default="f32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = time_updates(args.game, args.n_envs, args.variant, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Headline line of the PyTorch + CUDA port (toybox_tpu_torch) on one GPU:
batched env throughput, the render-inclusive pipeline rate and PPO's
train rate with its MFU, in the JSON line of the root ``bench.py``.

    python3 bench_torch.py [game] [n_envs] [--device cuda|cpu]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...},
with the keys of ``bench.py``'s line, two apart:

- ``train_mfu_f32_peak`` takes the place of ``train_mfu_f32_effective``:
  the achieved FLOP/s over the card's f32 peak outside the tensor cores
  (67 TFLOP/s on an H100 SXM). ``bench.py``'s key divides by a TPU's bf16
  peak / 3 (the MXU's 3-pass f32), which has no meaning on an H100.
- ``device``: the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` prints them
  ("cpu" with ``--device cpu``).

The primary metric is STATE-ONLY env stepping (no rendering) at 8 192
envs, the slowest of the games benchmarked; each game also reports the
pipeline rate (skip-4 stepping, the fused max-pool frame kernel, the
84x84 matmul warp and the 4-frame stack, ``make_rl_env``'s defaults) at
min(n_envs, 1 024) envs and one PPO ``train_step`` (rollout + minibatch
epochs) at that width. Each function runs one warm-up rep and reports
the best of ``reps``; every timed window starts and ends with
``torch.cuda.synchronize()``, so a rate counts finished device work.
Each step's actions are drawn on the device from a seeded
``torch.Generator``: no host-to-device copy in the loop.

Runs on ``cuda`` unless given ``--device cpu`` (``device="cpu"``); with
no card it raises rather than fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from toybox_tpu_torch.benchmark import clock, device_line, require_device
from toybox_tpu_torch.envs.batched import make_batched_env
from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl.ppo import make_ppo
from toybox_tpu_torch.utils.mfu import (device_peak_flops, network_fwd_flops,
                                        ppo_update_flops)

#: the north-star target of the JAX package (BASELINE.md: 10 M env
#: steps/s per host at 8 192 envs); a target, not a measurement
BASELINE_STEPS_PER_S = 10_000_000.0
ALL_GAMES = ("breakout", "amidar", "space_invaders")
PIPE_ENVS = 1024          # the pipeline and train width: min(n_envs, PIPE_ENVS)
TRAIN_NSTEPS, TRAIN_NOPTEPOCHS = 128, 4     # make_ppo's defaults (the recipe)


def _time_rollouts(rollout, state, units_per_rep: float, reps: int,
                   dev: torch.device) -> float:
    """One warm-up rollout, then the best rate (units/s) of ``reps``."""
    state = rollout(state)
    best = 0.0
    for _ in range(reps):
        t0 = clock(dev)
        state = rollout(state)
        best = max(best, units_per_rep / (clock(dev) - t0))
    return best


def _random_rollout(fns, n_envs: int, n_steps: int, dev: torch.device):
    """rollout(state) -> state: n_steps steps of uniform random actions
    drawn on the device from a generator seeded 0."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rollout(state):
        for _ in range(n_steps):
            actions = torch.randint(0, fns.num_actions, (n_envs,),
                                    generator=gen, device=dev)
            state = fns.step(state, actions)[0]
        return state

    return rollout


def bench_env_steps(game: str = "breakout", n_envs: int = 8192,
                    n_steps: int = 2048, obs_mode: str = "none",
                    reps: int = 3, device="cuda") -> float:
    """State-only stepping rate (env steps/s), no rendering."""
    dev = require_device(device)
    # fast_auto_reset is how training consumes the env (bit-exact while
    # nothing intervenes mid-run; see envs/batched.py)
    fns = make_batched_env(game, n_envs, obs_mode=obs_mode,
                           fast_auto_reset=True, device=dev)
    state, _ = fns.reset(torch.arange(n_envs, device=dev))
    return _time_rollouts(_random_rollout(fns, n_envs, n_steps, dev), state,
                          n_envs * n_steps, reps, dev)


def bench_pipeline(game: str = "breakout", n_envs: int = 1024,
                   n_steps: int = 256, reps: int = 3, device="cuda") -> float:
    """Render-inclusive training-pipeline rate (engine frames/s):
    make_rl_env's defaults, skip 4 with the fused max-pool frame kernel,
    the 84x84 matmul warp and the 4-frame stack."""
    dev = require_device(device)
    fns = make_rl_env(game, n_envs, device=dev)
    state, _ = fns.reset(torch.arange(n_envs, device=dev))
    frames_per_rep = n_envs * n_steps * fns.frames_per_step
    return _time_rollouts(_random_rollout(fns, n_envs, n_steps, dev), state,
                          frames_per_rep, reps, dev)


def forward_flops(act_fn, state, env, dev: torch.device) -> float:
    """Forward FLOPs a sample of the policy step ``act_fn`` on a zero
    uint8 batch of the env's width (the rows its noise is drawn for;
    FlopCounterMode counts matmuls and convolutions, which do the same
    work a sample at any width). The state's generator is left as it
    was."""
    obs = torch.zeros((env.num_envs,) + tuple(env.obs_shape),
                      dtype=torch.uint8, device=dev)
    gen_state = state.generator.get_state()
    fwd = network_fwd_flops(lambda o: act_fn(state, o), obs)
    state.generator.set_state(gen_state)
    return fwd


def build_train(game: str, n_envs: int, device="cuda", **ppo_kwargs):
    """(env, state, train_step, flops): make_ppo(make_rl_env(game,
    n_envs), total_updates=100, **ppo_kwargs) initialised from seed 0,
    with TF32 off (``regress.full_f32``), and the model FLOPs of one
    update: the forward a sample times n_envs x TRAIN_NSTEPS samples x
    (1 + 3 x TRAIN_NOPTEPOCHS), as the root ``bench.py`` counts them."""
    dev = require_device(device)
    full_f32()
    env = make_rl_env(game, n_envs, device=dev)
    init_fn, train_step, act_fn = make_ppo(env, total_updates=100,
                                           device=dev, **ppo_kwargs)
    state = init_fn(0)
    fwd = forward_flops(act_fn, state, env, dev)
    flops = (ppo_update_flops(fwd, n_envs * TRAIN_NSTEPS, TRAIN_NOPTEPOCHS)
             if fwd else None)
    return env, state, train_step, flops


def timed_update(train_step, state, dev: torch.device) -> tuple:
    """(state, seconds) of one train_step, to a synchronize."""
    t0 = clock(dev)
    state, _ = train_step(state)
    return state, clock(dev) - t0


def train_rates(frames: float, flops, seconds: float,
                dev: torch.device) -> dict:
    """frames/s, and where the FLOPs are known TFLOP/s and, on a card
    with published peaks, the MFU against its bf16 tensor-core peak and
    its f32 peak outside the tensor cores (the port trains in f32)."""
    out = {"train_frames_per_s": round(frames / seconds, 1)}
    if flops:
        achieved = flops / seconds
        out["train_tflops_per_s"] = round(achieved / 1e12, 4)
        bf16 = device_peak_flops(dev, dtype=torch.bfloat16)
        f32 = device_peak_flops(dev, dtype=torch.float32)
        if bf16 and f32:
            out["train_mfu_bf16_peak"] = round(achieved / bf16, 6)
            out["train_mfu_f32_peak"] = round(achieved / f32, 6)
    return out


def bench_train(game: str = "breakout", n_envs: int = 1024, reps: int = 3,
                device="cuda") -> dict:
    """End-to-end PPO train_step rate (engine frames/s) and MFU: the
    rollout (step, render, preprocess, policy) and the minibatch epochs
    at the reference hyperparameters; one warm-up update, then the best
    of ``reps``."""
    dev = require_device(device)
    env, state, train_step, flops = build_train(game, n_envs, dev)
    state, _ = timed_update(train_step, state, dev)
    best = float("inf")
    for _ in range(reps):
        state, dt = timed_update(train_step, state, dev)
        best = min(best, dt)
    frames = n_envs * TRAIN_NSTEPS * env.frames_per_step
    return train_rates(frames, flops, best, dev)


def bench_game(game: str, n_envs: int = 8192, device="cuda") -> dict:
    """One game's entry of the line's ``games``: the state-only rate at
    ``n_envs``, the pipeline rate and the train rate at min(n_envs,
    1 024) envs."""
    pipe_envs = min(n_envs, PIPE_ENVS)
    sps = bench_env_steps(game=game, n_envs=n_envs, device=device)
    pipe_fps = bench_pipeline(game=game, n_envs=pipe_envs, device=device)
    train = bench_train(game=game, n_envs=pipe_envs, device=device)
    return game_entry(sps, pipe_fps, train)


def game_entry(sps: float, pipe_fps: float, train: dict) -> dict:
    """One game's entry of the line's ``games`` from its state-only rate,
    its pipeline rate and ``bench_train``'s keys."""
    return {"env_steps_per_s": round(sps, 1),
            "pipeline_frames_per_s": round(pipe_fps, 1),
            "vs_baseline": round(sps / BASELINE_STEPS_PER_S, 4),
            **train}


def headline(per_game: dict, n_envs: int, dev: torch.device) -> dict:
    """The JSON line over each game's rates (``bench_game``'s keys): the
    headline value is the LOWEST state-stepping rate of the games."""
    pipe_envs = min(n_envs, PIPE_ENVS)
    headline_game = min(per_game, key=lambda g: per_game[g]["env_steps_per_s"])
    sps = per_game[headline_game]["env_steps_per_s"]
    return {
        "metric": f"min_env_steps_per_s_{n_envs}envs",
        "value": sps,
        "unit": "steps/s",
        "vs_baseline": round(sps / BASELINE_STEPS_PER_S, 4),
        "headline_game": headline_game,
        "pipeline_frames_per_s": per_game[headline_game][
            "pipeline_frames_per_s"],
        "compat_metric": f"{headline_game}_env_steps_per_s_{n_envs}envs",
        "measures": "state stepping only (no render), slowest of the games "
                    "benchmarked; per-game rates (incl. the render-inclusive "
                    "pipeline) under games.*",
        "games": per_game,
        "pipeline_envs": pipe_envs,
        "pipeline_measures": "step+fused maxpool frame kernel+warp84 "
                             "(matmuls)+stack4, skip=4, engine frames/s",
        "train_measures": "end-to-end PPO train_step (rollout + "
                          "minibatched SGD, f32 with TF32 off) engine "
                          f"frames/s at {pipe_envs} envs; MFU = model FLOPs "
                          "(FlopCounterMode forward x (1 + 3 x epochs)) / "
                          "wall / the card's dense peak: bf16 tensor-core "
                          "peak and f32 peak outside the tensor cores "
                          "(train_mfu_f32_peak; a TPU's f32-effective = "
                          "bf16 peak / 3 has no meaning on an H100)",
        "device": device_line(dev),
    }


def main(argv=None) -> dict:
    # default: ALL THREE games in one line; `bench_torch.py <game>
    # [n_envs]` narrows to one game
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("game", nargs="?", default=None)
    p.add_argument("n_envs", nargs="?", type=int, default=8192)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = require_device(args.device)
    games = (args.game,) if args.game else ALL_GAMES
    line = headline({game: bench_game(game, args.n_envs, dev)
                     for game in games}, args.n_envs, dev)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()

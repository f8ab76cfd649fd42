"""Behavioral regression gate on the GPU (port of toybox_tpu.regress).

Loads a saved model, plays N games, and exits -1 if the average score is
below a threshold (avg >= 50 over 10 games with a per-game score cap of
500, as the JAX gate).

    python -m toybox_tpu_torch.regress --env=BreakoutToyboxNoFrameskip-v4 \
        --load_path=models/Breakout.regress.model [--games=10] [--threshold=50]

Convolutions and matmuls run in full f32 (TF32 off), as the JAX reference
computes them.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np
import torch

from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.rl.policies import build_eval_policy

SCORE_CAP = 500       # early-done at score > 500
DEFAULT_THRESHOLD = 50
DEFAULT_GAMES = 10
MAX_FRAMES = 20_000   # per game safety cap

GAME_IDS = {
    "breakout": "breakout",
    "amidar": "amidar",
    "spaceinvaders": "space_invaders",
    "space_invaders": "space_invaders",
    "gridworld": "gridworld",
}
DEFAULT_NETWORK = {"ppo": "cnn", "ppo2": "cnn"}


def env_id_to_game(env_id: str) -> str:
    m = re.match(r"([A-Za-z]+?)(Toybox)?(NoFrameskip|Deterministic)?-v\d+",
                 env_id)
    name = (m.group(1) if m else env_id).lower()
    if name in GAME_IDS:
        return GAME_IDS[name]
    raise ValueError(f"unknown env id {env_id!r}")


def full_f32() -> None:
    """Turn TF32 off for convolutions and matmuls (full f32, as the JAX
    reference computes)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def play_games(game: str, state_dict, network: str, n_games: int,
               score_cap: int = SCORE_CAP, seed: int = 0, chunk: int = 128,
               alg: str = "ppo", device="cuda", max_frames: int = MAX_FRAMES,
               on_chunk=None):
    """Play games with the trained policy on the batched env, one env per
    game. ``state_dict=None`` plays a randomly initialised policy. The
    host checks for the end every ``chunk`` agent steps (one sync per
    chunk); ``on_chunk(steps, totals)`` is called after each chunk.
    Returns the per-game raw scores (numpy f32)."""
    env = make_rl_env(game, n_games, episodic_life=False, clip_rewards=False,
                      device=device)
    module, p_step = build_eval_policy(alg, env.obs_shape, env.num_actions,
                                       network, seed=seed, device=device)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    st, _ = env.reset(torch.arange(n_games, device=dev) + seed)
    totals = torch.zeros(n_games, dtype=torch.float32, device=dev)
    finished = torch.zeros(n_games, dtype=torch.bool, device=dev)
    steps = 0
    for _ in range(max_frames // 4 // chunk):
        for _ in range(chunk):
            actions, _, _, _ = p_step(st.frames, gen)
            st, _, _, done, info = env.step(st, actions)
            totals = torch.where(finished, totals,
                                 totals + info["raw_reward"])
            # early-done at the cap or game over
            finished = finished | done | (totals > score_cap)
        steps += chunk
        if on_chunk is not None:
            on_chunk(steps, totals)
        if bool(finished.all()):
            break
    return totals.cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", type=str,
                        default="BreakoutToyboxNoFrameskip-v4")
    parser.add_argument("--alg", type=str, default="ppo")
    parser.add_argument("--load_path", type=str, default=None)
    parser.add_argument("--network", type=str, default=None)
    parser.add_argument("--games", type=int, default=DEFAULT_GAMES)
    parser.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    full_f32()
    game = env_id_to_game(args.env)
    network = args.network or DEFAULT_NETWORK.get(args.alg, "cnn")
    state_dict = load_state_dict(args.load_path) if args.load_path else None

    t0 = time.perf_counter()
    scores = play_games(game, state_dict, network, args.games,
                        seed=args.seed, alg=args.alg)
    elapsed = time.perf_counter() - t0
    avg = float(np.mean(scores))
    print(f"scores: {scores.tolist()}")
    print(f"average: {avg:.2f} (threshold {args.threshold})")
    print(f"elapsed: {elapsed:.1f} s on {torch.cuda.get_device_name()}")
    if avg < args.threshold:
        print("REGRESSION: average score below threshold")
        sys.exit(-1)
    print("PASS")


if __name__ == "__main__":
    main()

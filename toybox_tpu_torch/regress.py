"""Behavioral regression gate on the GPU (port of toybox_tpu.regress).

Loads a saved model, plays N games, and exits -1 if the average score is
below a threshold (avg >= 50 over 10 games with a per-game score cap of
500, as the JAX gate).

    python -m toybox_tpu_torch.regress --env=BreakoutToyboxNoFrameskip-v4 \
        --load_path=models/Breakout.regress.model [--alg=ppo] \
        [--network=cnn] [--games=10] [--threshold=50] [--device=cuda] \
        [--max_frames=20000]

Any alg's checkpoint plays through its eval head (``rl/policies.py``);
``--network`` defaults to the alg's (``run.ALG_DEFAULTS``). Recurrent
networks (cnn_lstm, cnn_lnlstm, lstm) thread the LSTM carry, restarting it
for the envs whose previous step ended an episode. Convolutions and
matmuls run in full f32 (TF32 off), as the JAX reference computes them;
the ``*_bf16`` checkpoints hold f32 parameters and play in f32, as the
JAX gate plays them.
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
from toybox_tpu_torch.rl.policies import RECURRENT_NETWORKS, \
    build_eval_head

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


def eval_policy(alg: str, network: str, env, seed: int, device,
                nlstm: int = 128):
    """(module, step, carry): the eval head of ``alg``/``network`` for
    ``env`` (a recurrent head ``nlstm`` wide), ``step(obs, generator,
    carry, prev_done) -> (actions, carry)`` for every head (a
    feed-forward head passes the carry through), and the first carry
    (None for a feed-forward head)."""
    module, p_step = build_eval_head(alg, env.obs_shape, env.num_actions,
                                     network, nlstm=nlstm, seed=seed,
                                     device=device)
    if network in RECURRENT_NETWORKS:
        def step(obs, generator, carry, prev_done):
            actions, _, _, carry = p_step(obs, generator, carry, prev_done)
            return actions, carry

        return module, step, module.initial_carry(env.num_envs)

    def step(obs, generator, carry, prev_done):
        return p_step(obs, generator)[0], carry

    return module, step, None


def play_games(game: str, state_dict, network: str, n_games: int,
               score_cap: int = SCORE_CAP, seed: int = 0, chunk: int = 128,
               alg: str = "ppo", device="cuda", max_frames: int = MAX_FRAMES,
               on_chunk=None):
    """Play games with the trained policy on the batched env, one env per
    game. ``state_dict=None`` plays a randomly initialised policy; else it
    is loaded strictly into the eval head of ``alg``/``network``. The
    host checks for the end every ``chunk`` agent steps (one sync per
    chunk); ``on_chunk(steps, totals)`` is called after each chunk.
    Returns the per-game raw scores (numpy f32)."""
    env = make_rl_env(game, n_games, episodic_life=False, clip_rewards=False,
                      device=device)
    module, step, carry = eval_policy(alg, network, env, seed, device)
    if state_dict is not None:
        module.load_state_dict(state_dict)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    st, _ = env.reset(torch.arange(n_games, device=dev) + seed)
    totals = torch.zeros(n_games, dtype=torch.float32, device=dev)
    finished = torch.zeros(n_games, dtype=torch.bool, device=dev)
    done = torch.zeros(n_games, dtype=torch.bool, device=dev)
    steps = 0
    for _ in range(max_frames // 4 // chunk):
        for _ in range(chunk):
            actions, carry = step(st.frames, gen, carry, done)
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
    parser.add_argument("--max_frames", type=int, default=MAX_FRAMES,
                        help="per-game frame cap (a tiny depth on the CPU)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from toybox_tpu_torch.run import default_network

    full_f32()
    game = env_id_to_game(args.env)
    network = args.network or default_network(args.alg)
    state_dict = load_state_dict(args.load_path) if args.load_path else None

    t0 = time.perf_counter()
    scores = play_games(game, state_dict, network, args.games,
                        seed=args.seed, alg=args.alg, device=args.device,
                        max_frames=args.max_frames)
    elapsed = time.perf_counter() - t0
    avg = float(np.mean(scores))
    print(f"scores: {scores.tolist()}")
    print(f"average: {avg:.2f} (threshold {args.threshold})")
    where = (torch.cuda.get_device_name() if args.device.startswith("cuda")
             else args.device)
    print(f"elapsed: {elapsed:.1f} s on {where}")
    if avg < args.threshold:
        print("REGRESSION: average score below threshold")
        sys.exit(-1)
    print("PASS")


if __name__ == "__main__":
    main()

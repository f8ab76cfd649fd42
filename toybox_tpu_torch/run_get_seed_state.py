"""Seed-state extraction (port of toybox_tpu.run_get_seed_state, the
reference baselines/run_get_seed_state.py).

Plays an agent (trained or random) on one ``Toybox`` handle until a
game-state predicate holds, then dumps the state JSON as an
acceptance-test fixture (tests/fixtures/seed_states/ were made so):

    python -m toybox_tpu_torch.run_get_seed_state \
        --env=BreakoutToyboxNoFrameskip-v4 --predicate=life_lost \
        [--alg=ppo1 --load_path=models/Breakout.ppo1.model] \
        [--out=seed_states] [--device=cuda]

A trained agent plays through the single-env eval adapter
(``rl/eval_adapter.py`` ``make_tb_policy``), its network from the alg's
defaults (``run.alg_defaults``) unless ``--network`` names one. One engine
frame at N = 1 is a few hundred small launches on the card, so a
predicate that takes tens of thousands of frames takes minutes there.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _life_lost(tb) -> bool:
    """At least one life lost: lives below the game's configured start
    (Breakout starts at 5, Amidar/SI at 3)."""
    start = int(getattr(tb.rsimulator.config, "start_lives", 3))
    return tb.get_lives() < start


PREDICATES = {
    # breakout: one brick left (reference :266)
    "last_brick": lambda tb: tb.rstate.breakout_bricks_remaining() == 1,
    # breakout: at least one open channel (reference :270)
    "channel": lambda tb: tb.rstate.breakout_channel_count() >= 1,
    "score_100": lambda tb: tb.get_score() >= 100,
    "life_lost": _life_lost,
}


def extract_seed_state(game: str, predicate: str, max_frames: int = 50_000,
                       seed: int = 0, policy=None, device="cuda"):
    """Play until the predicate holds; returns (state_json, frame_idx) or
    (None, -1). Without a policy the actions are random (FIRE every 29th
    frame), drawn from ``np.random.default_rng(seed)``."""
    from toybox_tpu_torch import Toybox

    pred = PREDICATES[predicate]
    tb = Toybox(game, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    legal = tb.get_legal_action_set()
    for frame in range(max_frames):
        if policy is not None:
            action = policy(tb)
        else:
            # FIRE occasionally to serve/jump, otherwise random
            action = 1 if frame % 29 == 0 else int(rng.choice(legal))
        tb.apply_ale_action(action)
        if tb.game_over():
            tb.new_game()
            if policy is not None and hasattr(policy, "reset"):
                policy.reset()   # restart the adapter's obs stack
            continue
        if pred(tb):
            return tb.to_state_json(), frame
    return None, -1


def main(argv=None):
    from toybox_tpu_torch.regress import env_id_to_game, full_f32
    from toybox_tpu_torch.run import default_network

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", type=str,
                        default="BreakoutToyboxNoFrameskip-v4")
    parser.add_argument("--predicate", type=str, default="channel",
                        choices=sorted(PREDICATES))
    parser.add_argument("--out", type=str, default="seed_states")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_frames", type=int, default=50_000)
    parser.add_argument("--alg", type=str, default="ppo")
    parser.add_argument("--network", type=str, default=None)
    parser.add_argument("--load_path", type=str, default=None,
                        help="play a trained agent (the reference extracts "
                             "seed states from trained models)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    full_f32()
    game = env_id_to_game(args.env)
    policy = None
    if args.load_path:
        from toybox_tpu_torch.rl.checkpoint import load_state_dict
        from toybox_tpu_torch.rl.eval_adapter import make_tb_policy

        network = args.network or default_network(args.alg)
        policy = make_tb_policy(args.alg, network,
                                load_state_dict(args.load_path), game,
                                seed=args.seed, device=args.device)
    state, frame = extract_seed_state(game, args.predicate,
                                      max_frames=args.max_frames,
                                      seed=args.seed, policy=policy,
                                      device=args.device)
    if state is None:
        print(f"predicate {args.predicate!r} never held in "
              f"{args.max_frames} frames")
        return 1
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        f"{game}_{args.predicate}_seed{args.seed}.json")
    with open(path, "w") as f:
        json.dump(state, f)
    print(f"predicate {args.predicate!r} held at frame {frame}; "
          f"state written to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Count the PyTorch operator calls of the port's serving path, per game.

    PYTHONPATH=. python scripts/port_op_counts.py [--device cpu] [--envs 10]

For each ported game it prints the top-level ``aten::`` calls that
``torch.profiler`` records for one agent step of the regress path (the
policy and the DeepMind pipeline, averaged over 5 steps), for one step of
the batched env (engine, auto-reset and bookkeeping) and for one engine
step alone. Each such call is about one kernel launch on the card, so the
counts predict the host's dispatch work; they are counts, not times.
"""

from __future__ import annotations

import argparse

import torch
from torch.profiler import ProfilerActivity, profile

from toybox_tpu_torch.core.actions import ale_to_input
from toybox_tpu_torch.envs.batched import get_game, make_batched_env
from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.rl.policies import build_eval_policy

GAMES = ("breakout", "space_invaders", "amidar")


def top_level_aten_calls(prof) -> int:
    """aten calls not made from inside another aten call."""
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def count(game: str, n: int, device: str) -> dict:
    env = make_rl_env(game, n, device=device)
    _, p_step = build_eval_policy("ppo", env.obs_shape, env.num_actions,
                                  "cnn", device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    st, _ = env.reset(torch.arange(n, device=device))
    for _ in range(3):
        actions, _, _, _ = p_step(st.frames, gen)
        st, _, _, _, _ = env.step(st, actions)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            actions, _, _, _ = p_step(st.frames, gen)
            st, _, _, _, _ = env.step(st, actions)
    agent_step = top_level_aten_calls(prof) / 5

    module = get_game(game)
    cfg = module.default_config(device)
    inner = make_batched_env(game, n, config=cfg, fast_auto_reset=True)
    est, _ = inner.reset(torch.arange(n, device=device))
    fire = torch.ones(n, dtype=torch.long, device=device)
    for _ in range(3):
        est, _, _, _, _ = inner.step(est, fire)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inner.step(est, fire)
    env_step = top_level_aten_calls(prof)
    legal = torch.as_tensor(module.LEGAL_ACTIONS, device=device)
    inp = ale_to_input(legal[fire])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        module.step(cfg, est.game, inp)
    return {"agent_step": agent_step, "env_step": env_step,
            "engine_step": top_level_aten_calls(prof)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--envs", type=int, default=10)
    args = parser.parse_args(argv)
    for game in GAMES:
        c = count(game, args.envs, args.device)
        print(f"{game}: {c['agent_step']:g} aten calls per agent step; "
              f"batched env step {c['env_step']}, of which the engine step "
              f"{c['engine_step']} ({args.envs} envs, {args.device})")


if __name__ == "__main__":
    main()

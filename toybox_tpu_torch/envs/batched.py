"""Batched device-resident environments (port of
toybox_tpu.envs.batched ``make_batched_env``).

State is a struct of tensors with a leading env axis; ``step`` steps every
env at once, auto-resets finished envs with a masked select, and returns
reward = max(score delta, 0) and done = lives <= 0. This slice ports the
env the pipeline drives, which renders no frame of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from toybox_tpu_torch.core import rng as _rng
from toybox_tpu_torch.core.actions import ale_to_input
from toybox_tpu_torch.games import amidar, breakout, space_invaders

I32 = torch.int32
F32 = torch.float32

GAMES = {"breakout": breakout, "space_invaders": space_invaders,
         "amidar": amidar}


def get_game(name: str):
    try:
        return GAMES[name]
    except KeyError:
        raise ValueError(f"game {name!r} is not ported yet; have "
                         f"{sorted(GAMES)}") from None


@dataclasses.dataclass(frozen=True)
class EnvState:
    game: Any                      # game State [N, ...]
    prev_score: torch.Tensor       # i32[N] score at previous step
    episode_return: torch.Tensor   # f32[N]
    episode_length: torch.Tensor   # i32[N]
    seeds: torch.Tensor            # int64[N] u32 reseed counters


@dataclasses.dataclass(frozen=True)
class BatchedEnvFns:
    """Functions over EnvState (the JAX package's BatchedEnvFns)."""
    game_name: str
    num_envs: int
    obs_mode: str
    reset: Callable  # (seeds [N]) -> (state, obs)
    step: Callable   # (state, actions [N]) -> (state, obs, rew, done, info)
    obs_shape: tuple
    num_actions: int
    legal_actions: tuple
    frames_per_step: int = 1


def make_batched_env(game_name: str, num_envs: int, config=None,
                     fast_auto_reset: bool = False,
                     device="cuda") -> BatchedEnvFns:
    """Auto-resetting batched env that renders no frame (obs is None; the
    DeepMind pipeline renders its own).

    fast_auto_reset: skip the auto-reset select on the game's
    STEP_CONSTANT_FIELDS, which only new_game writes. Exact unless an
    intervention changed one of them mid-run; training never does. A game
    that lists no such fields takes the full select."""
    module = get_game(game_name)
    fast = fast_auto_reset and bool(getattr(module, "STEP_CONSTANT_FIELDS",
                                            ()))
    if config is None:
        config = module.default_config(device)
    dev = config.device
    legal = tuple(module.LEGAL_ACTIONS)
    legal_t = torch.as_tensor(legal, dtype=torch.int64, device=dev)

    def _wrap(game, seeds):
        state = EnvState(
            game=game,
            prev_score=module.score(game).to(I32),
            episode_return=torch.zeros(num_envs, dtype=F32, device=dev),
            episode_length=torch.zeros(num_envs, dtype=I32, device=dev),
            seeds=seeds)
        return state, None

    def reset(seeds):
        seeds = torch.as_tensor(seeds, device=dev).to(torch.int64) \
            & _rng.MASK32
        return _wrap(module.new_game(config, seeds), seeds)

    def step(state: EnvState, actions):
        """actions: int[N] indices into the legal action set."""
        actions = torch.as_tensor(actions, device=dev).long()
        game = module.step(config, state.game, ale_to_input(legal_t[actions]))

        score = module.score(game).to(I32)
        lives = module.lives(game).to(I32)
        reward = (score - state.prev_score).clamp_min(0).to(F32)
        done = lives <= 0

        ep_ret = state.episode_return + reward
        ep_len = state.episode_length + 1

        # auto-reset, reseeded deterministically per episode (u32 wrap)
        new_seeds = (_rng.mul32(state.seeds, 2654435761) + num_envs) \
            & _rng.MASK32
        seeds = torch.where(done, new_seeds, state.seeds)
        if fast:
            fresh = module.dynamic_fields(config, _rng.seed(seeds))
        else:
            new = module.new_game(config, seeds)
            fresh = {f: getattr(new, f) for f in module.FIELDS}
        game = game.replace(**{
            name: torch.where(done.view((-1,) + (1,) * (v.dim() - 1)),
                              v, getattr(game, name))
            for name, v in fresh.items()})
        score_after = torch.where(done, module.score(game).to(I32), score)

        zero_i = torch.zeros((), dtype=I32, device=dev)
        info = {
            "lives": lives,
            "score": torch.where(done, zero_i, score),
            "episode_return": torch.where(
                done, ep_ret, torch.full((), float("nan"), device=dev)),
            "episode_length": torch.where(done, ep_len, zero_i),
        }
        new_state = EnvState(
            game=game,
            prev_score=score_after,
            episode_return=torch.where(done, torch.zeros_like(ep_ret), ep_ret),
            episode_length=torch.where(done, zero_i, ep_len),
            seeds=seeds)
        return new_state, None, reward, done, info

    return BatchedEnvFns(
        game_name=game_name, num_envs=num_envs, obs_mode="none",
        reset=reset, step=step, obs_shape=(0,),
        num_actions=len(legal), legal_actions=legal)

"""Batched device-resident environments (port of
toybox_tpu.envs.batched).

State is a struct of tensors with a leading env axis; ``step`` steps every
env at once, auto-resets finished envs with a masked select (unless
``auto_reset=False``), and returns reward = max(score delta, 0) and done =
lives <= 0. ``reset_to`` starts every env from one single-env state (the
batched ``write_state_json``).

Two layers, as in the JAX package:
- functional: ``make_batched_env(...) -> BatchedEnvFns`` with
  ``reset(seeds)`` / ``step(state, actions)``;
- stateful: ``BatchedEnv``, which owns the state (the VecEnv user
  surface).

Observations (``obs_mode``): ``"grayscale"`` u8[N, H, W, 1], ``"rgba"``
u8[N, H, W, 4], ``"rgb"`` u8[N, H, W, 3], each from the game's plain
``render`` as the JAX modes are, or ``"none"`` (obs is None), which the
DeepMind pipeline takes: it renders its own frames.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from toybox_tpu_torch.core import rng as _rng
from toybox_tpu_torch.core.actions import ale_to_input
from toybox_tpu_torch.games import get_game
from toybox_tpu_torch.games.common import luma2d

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class EnvState:
    game: Any                      # game State [N, ...]
    prev_score: torch.Tensor       # i32[N] score at previous step
    episode_return: torch.Tensor   # f32[N]
    episode_length: torch.Tensor   # i32[N]
    seeds: torch.Tensor            # int64[N] u32 reseed counters
    # False after reset_to: the step-constant fields may hold values that
    # new_game does not write, so an auto-reset selects every field
    constants_fresh: bool = True


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
    # (tree, seeds, reseed=True) -> (state, obs): every env from one
    # single-env game state (a batch of one, e.g. state_from_json)
    reset_to: Callable = None


def _make_obs_fn(module, obs_mode):
    """(fn(config, game) -> obs [N, ...] or None, per-env obs shape)."""
    if obs_mode == "none":
        return (lambda config, game: None), (0,)
    h, w = module.HEIGHT, module.WIDTH
    if obs_mode == "grayscale":
        return ((lambda config, game: luma2d(module.render(config, game))
                 [..., None]), (h, w, 1))
    if obs_mode == "rgba":
        return (lambda config, game: module.render(config, game)), (h, w, 4)
    if obs_mode == "rgb":
        return ((lambda config, game: module.render(config, game)[..., :3]),
                (h, w, 3))
    raise ValueError(f"unknown obs_mode {obs_mode!r}")


def make_batched_env(game_name: str, num_envs: int, config=None,
                     obs_mode: str = "grayscale", auto_reset: bool = True,
                     fast_auto_reset: bool = False, seed_stride=None,
                     device="cuda") -> BatchedEnvFns:
    """Batched env over ``game_name``'s engine on ``config.device`` (or on
    ``device`` with the default config).

    auto_reset: a finished env starts a new game, reseeded per episode,
    in the same step; with False it stays finished and keeps its score.

    fast_auto_reset: skip the auto-reset select on the game's
    STEP_CONSTANT_FIELDS, which only new_game writes, for states that
    ``reset`` started. A state from ``reset_to`` may hold other values in
    those fields (an intervention wrote them), so its auto-resets select
    every field, as new_game resets them. A game that lists no such fields
    takes the full select.

    seed_stride: what an auto-reset adds to the scrambled seed (default
    ``num_envs``). A rank's block of an env set spread over a mesh passes
    the whole set's count, so that its envs play the games that the same
    envs of one process would."""
    module = get_game(game_name)
    stride = num_envs if seed_stride is None else int(seed_stride)
    fast = fast_auto_reset and bool(getattr(module, "STEP_CONSTANT_FIELDS",
                                            ()))
    if config is None:
        config = module.default_config(device)
    dev = config.device
    obs_fn, obs_shape = _make_obs_fn(module, obs_mode)
    legal = tuple(module.LEGAL_ACTIONS)
    legal_t = torch.as_tensor(legal, dtype=torch.int64, device=dev)

    def _wrap(game, seeds, constants_fresh=True):
        state = EnvState(
            game=game,
            prev_score=module.score(game).to(I32),
            episode_return=torch.zeros(num_envs, dtype=F32, device=dev),
            episode_length=torch.zeros(num_envs, dtype=I32, device=dev),
            seeds=seeds, constants_fresh=constants_fresh)
        return state, obs_fn(config, game)

    def _seeds(seeds):
        return torch.as_tensor(seeds, device=dev).to(torch.int64) \
            & _rng.MASK32

    def reset(seeds):
        seeds = _seeds(seeds)
        return _wrap(module.new_game(config, seeds), seeds)

    def reset_to(tree, seeds, reseed: bool = True):
        """Start every env from ``tree``, one env's game state (a batch of
        one, e.g. ``module.state_from_json``): the batched analog of
        ``write_state_json``. With ``reseed`` each env's engine rng is
        derived from its seed, so that stochastic branches differ between
        envs; ``reseed=False`` replays the stored rng in every env."""
        seeds = _seeds(seeds)
        game = tree.replace(**{
            f: getattr(tree, f).to(dev).expand(
                (num_envs,) + tuple(getattr(tree, f).shape[1:]))
            for f in module.FIELDS})
        if reseed:
            game = game.replace(rng=_rng.seed(seeds))
        return _wrap(game, seeds, constants_fresh=False)

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

        if auto_reset:
            # reseeded deterministically per episode (u32 wrap)
            new_seeds = (_rng.mul32(state.seeds, 2654435761) + stride) \
                & _rng.MASK32
            seeds = torch.where(done, new_seeds, state.seeds)
            if fast and state.constants_fresh:
                fresh = module.dynamic_fields(config, _rng.seed(seeds))
            else:
                new = module.new_game(config, seeds)
                fresh = {f: getattr(new, f) for f in module.FIELDS}
            game = game.replace(**{
                name: torch.where(done.view((-1,) + (1,) * (v.dim() - 1)),
                                  v, getattr(game, name))
                for name, v in fresh.items()})
            score_after = torch.where(done, module.score(game).to(I32),
                                      score)
        else:
            seeds = state.seeds
            score_after = score

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
            seeds=seeds, constants_fresh=state.constants_fresh)
        return new_state, obs_fn(config, game), reward, done, info

    return BatchedEnvFns(
        game_name=game_name, num_envs=num_envs, obs_mode=obs_mode,
        reset=reset, step=step, obs_shape=obs_shape,
        num_actions=len(legal), legal_actions=legal, reset_to=reset_to)


class BatchedEnv:
    """Stateful wrapper over ``make_batched_env`` (the VecEnv user
    surface): reset() -> obs [N, ...]; step(actions) -> (obs, rew, done,
    info), all tensors on the env's device."""

    def __init__(self, game_name: str, num_envs: int, config=None,
                 obs_mode: str = "grayscale", auto_reset: bool = True,
                 seed: int = 0, device="cuda"):
        self.fns = make_batched_env(game_name, num_envs, config=config,
                                    obs_mode=obs_mode, auto_reset=auto_reset,
                                    device=device)
        self.num_envs = num_envs
        self.device = torch.device(device if config is None
                                   else config.device)
        self._seed = seed
        self.state = None

    @property
    def num_actions(self) -> int:
        return self.fns.num_actions

    def reset(self, seed: int | None = None):
        """Every env from a new game, seeded ``seed + i`` (u32 wrap)."""
        if seed is not None:
            self._seed = seed
        seeds = (int(self._seed) + torch.arange(self.num_envs)) & _rng.MASK32
        self.state, obs = self.fns.reset(seeds.to(self.device))
        return obs

    def step(self, actions):
        self.state, obs, rew, done, info = self.fns.step(self.state, actions)
        return obs, rew, done, info

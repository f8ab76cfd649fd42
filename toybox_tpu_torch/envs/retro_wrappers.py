"""Gym-Retro compatibility wrappers (port of
toybox_tpu.envs.retro_wrappers, gymnasium and numpy only) — the reference's
baselines/common/retro_wrappers.py surface rebuilt on gymnasium
(reference retro_wrappers.py:6-291).

The generic pieces (TimeLimit, StochasticFrameSkip, PartialFrameStack,
Downsample, Rgb2gray, StartDoingRandomActionsWrapper, RewardScaler,
AllowBacktracking, AppendTimeout) work on ANY gymnasium env, including
the Toybox envs here. The pieces that require the `retro` package
(make_retro, SonicDiscretizer's button map, wrap_deepmind_retro's retro
game handle) raise a clear ImportError when retro is absent — it is not
installable in this environment and Toybox has no Retro games, but the
wrapper logic itself is the reference-parity surface.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
from gymnasium import spaces


class TimeLimit(gym.Wrapper):
    """Truncate episodes at max_episode_steps (retro_wrappers.py:6-22;
    gymnasium's TimeLimit signals truncation the same way)."""

    def __init__(self, env, max_episode_steps=None):
        super().__init__(env)
        self._max_episode_steps = max_episode_steps
        self._elapsed_steps = 0

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self._elapsed_steps += 1
        if (self._max_episode_steps is not None
                and self._elapsed_steps >= self._max_episode_steps):
            trunc = True
            info["TimeLimit.truncated"] = True
        return obs, reward, term, trunc, info

    def reset(self, **kwargs):
        self._elapsed_steps = 0
        return self.env.reset(**kwargs)


class StochasticFrameSkip(gym.Wrapper):
    """Skip n frames with sticky actions: with prob ``stickprob`` the
    PREVIOUS action repeats for the first substep of the skip
    (retro_wrappers.py:24-60 — the Machado et al. sticky-action
    protocol)."""

    def __init__(self, env, n, stickprob):
        super().__init__(env)
        self.n = n
        self.stickprob = stickprob
        self.curac = None
        self.rng = np.random.default_rng()

    def reset(self, *, seed=None, **kwargs):
        self.curac = None
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        return self.env.reset(seed=seed, **kwargs)

    def step(self, action):
        term = trunc = False
        totrew = 0.0
        obs, info = None, {}
        for i in range(self.n):
            # first substep: maybe keep the old action; later substeps
            # always use the new one (the reference's i==0/i==1 split)
            if self.curac is None or i > 0 or (
                    self.rng.random() > self.stickprob):
                self.curac = action
            obs, rew, term, trunc, info = self.env.step(self.curac)
            totrew += rew
            if term or trunc:
                break
        return obs, totrew, term, trunc, info


class PartialFrameStack(gym.Wrapper):
    """Stack k frames but keep only ONE channel from the older frames
    (retro_wrappers.py:62-92): the newest frame contributes all its
    channels, history contributes channel ``channel``."""

    def __init__(self, env, k, channel=1):
        super().__init__(env)
        self.k = k
        self.channel = channel
        shp = env.observation_space.shape
        self.frames = []
        self.observation_space = spaces.Box(
            low=0, high=255,
            shape=(shp[0], shp[1], shp[2] + k - 1),
            dtype=env.observation_space.dtype)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        self.frames = [obs] * self.k
        return self._get_ob(), info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self.frames = self.frames[1:] + [obs]
        return self._get_ob(), reward, term, trunc, info

    def _get_ob(self):
        parts = [f if i == self.k - 1 else f[..., self.channel:self.channel + 1]
                 for i, f in enumerate(self.frames)]
        return np.concatenate(parts, axis=-1)


class Downsample(gym.ObservationWrapper):
    """Integer-ratio spatial downsample (retro_wrappers.py:94-110)."""

    def __init__(self, env, ratio):
        super().__init__(env)
        self.ratio = ratio
        oldh, oldw, oldc = env.observation_space.shape
        newshape = ((oldh + ratio - 1) // ratio,
                    (oldw + ratio - 1) // ratio, oldc)
        self.observation_space = spaces.Box(
            low=0, high=255, shape=newshape,
            dtype=env.observation_space.dtype)

    def observation(self, frame):
        return frame[::self.ratio, ::self.ratio]


class Rgb2gray(gym.ObservationWrapper):
    """Luma conversion to a 1-channel frame (retro_wrappers.py:112-125)."""

    def __init__(self, env):
        super().__init__(env)
        oldh, oldw, _ = env.observation_space.shape
        self.observation_space = spaces.Box(
            low=0, high=255, shape=(oldh, oldw, 1), dtype=np.uint8)

    def observation(self, frame):
        luma = (0.299 * frame[..., 0] + 0.587 * frame[..., 1]
                + 0.114 * frame[..., 2])
        return luma.astype(np.uint8)[..., None]


class MovieRecord(gym.Wrapper):
    """Record a retro .bk2 movie every k-th episode
    (retro_wrappers.py:127-142). Needs an env exposing
    unwrapped.movie_path (gym-retro); errors clearly otherwise."""

    def __init__(self, env, savedir, k):
        super().__init__(env)
        self.savedir = savedir
        self.k = k
        self.epcount = 0
        if not hasattr(env.unwrapped, "record_movie"):
            raise TypeError(
                "MovieRecord needs a gym-retro env (record_movie); "
                "Toybox envs record via save_frame_image / start_images")

    def reset(self, **kwargs):
        if self.epcount % self.k == 0:
            self.env.unwrapped.movie_id = self.epcount
        self.epcount += 1
        return self.env.reset(**kwargs)


class AppendTimeout(gym.Wrapper):
    """Dict observation {original, remaining fraction of the time limit}
    (retro_wrappers.py:144-184)."""

    def __init__(self, env):
        super().__init__(env)
        self.timeout_space = spaces.Box(
            low=np.array([0.0]), high=np.array([1.0]), dtype=np.float32)
        self.original_os = env.observation_space
        if isinstance(self.original_os, spaces.Dict):
            self.dict_mode = True
            d = dict(self.original_os.spaces)
            d["value_estimation_timeout"] = self.timeout_space
            self.observation_space = spaces.Dict(d)
        else:
            self.dict_mode = False
            self.observation_space = spaces.Dict(
                {"original": self.original_os,
                 "value_estimation_timeout": self.timeout_space})
        # find the TimeLimit in the stack, like the reference walks .env
        self.timeout_key = "value_estimation_timeout"
        w = env
        self._max_episode_steps = None
        while w is not None:
            if hasattr(w, "_max_episode_steps"):
                self._max_episode_steps = w._max_episode_steps
                break
            w = getattr(w, "env", None)
        if self._max_episode_steps is None:
            raise ValueError("AppendTimeout needs a TimeLimit in the stack")
        self._elapsed = 0

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self._elapsed += 1
        return self._process(obs), reward, term, trunc, info

    def reset(self, **kwargs):
        self._elapsed = 0
        obs, info = self.env.reset(**kwargs)
        return self._process(obs), info

    def _process(self, obs):
        frac = max(self._max_episode_steps - self._elapsed, 0) \
            / self._max_episode_steps
        t = np.array([frac], dtype=np.float32)
        if self.dict_mode:
            out = dict(obs)
            out[self.timeout_key] = t
            return out
        return {"original": obs, self.timeout_key: t}


class StartDoingRandomActionsWrapper(gym.Wrapper):
    """Random warmup actions on startup / each episode so the agent sees
    varied initial states (retro_wrappers.py:186-215)."""

    def __init__(self, env, max_random_steps, on_startup=True,
                 every_episode=False):
        super().__init__(env)
        self.on_startup = on_startup
        self.every_episode = every_episode
        self.max_random_steps = max_random_steps
        self.random_steps_done = not on_startup
        self.last = None

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        self.last = (obs, info)
        if not self.random_steps_done or self.every_episode:
            n = int(self.np_random.integers(1, self.max_random_steps + 1))
            for _ in range(n):
                obs, _, term, trunc, info = self.env.step(
                    self.env.action_space.sample())
                if term or trunc:
                    obs, info = self.env.reset(**kwargs)
                self.last = (obs, info)
            self.random_steps_done = True
        return self.last

    def step(self, action):
        return self.env.step(action)


class SonicDiscretizer(gym.ActionWrapper):
    """Sonic-specific button-combo discretization
    (retro_wrappers.py:237-256): maps 7 discrete actions onto the Genesis
    12-button multibinary space."""

    COMBOS = [["LEFT"], ["RIGHT"], ["LEFT", "DOWN"], ["RIGHT", "DOWN"],
              ["DOWN"], ["DOWN", "B"], ["B"]]
    BUTTONS = ["B", "A", "MODE", "START", "UP", "DOWN", "LEFT", "RIGHT",
               "C", "Y", "X", "Z"]

    def __init__(self, env):
        super().__init__(env)
        self._actions = []
        for combo in self.COMBOS:
            arr = np.array([False] * len(self.BUTTONS))
            for button in combo:
                arr[self.BUTTONS.index(button)] = True
            self._actions.append(arr)
        self.action_space = spaces.Discrete(len(self._actions))

    def action(self, a):
        return self._actions[a].copy()


class RewardScaler(gym.RewardWrapper):
    """Scale rewards by a constant (retro_wrappers.py:258-269 — affects
    PPO performance materially on Retro games)."""

    def __init__(self, env, scale=0.01):
        super().__init__(env)
        self.scale = scale

    def reward(self, reward):
        return reward * self.scale


class AllowBacktracking(gym.Wrapper):
    """Reward = per-step gain in MAX progress, so going backwards is
    free but net progress still pays (retro_wrappers.py:271-291)."""

    def __init__(self, env):
        super().__init__(env)
        self._cur_x = 0.0
        self._max_x = 0.0

    def reset(self, **kwargs):
        self._cur_x = 0.0
        self._max_x = 0.0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self._cur_x += reward
        reward = max(0.0, self._cur_x - self._max_x)
        self._max_x = max(self._max_x, self._cur_x)
        return obs, reward, term, trunc, info


def make_retro(*, game, state=None, max_episode_steps=4500, **kwargs):
    """Reference retro_wrappers.py:218-224. Requires the `retro` package
    (not installable in this environment — Toybox ships no Retro
    games)."""
    try:
        import retro
    except ImportError as e:
        raise ImportError(
            "make_retro requires gym-retro, which is not installed; "
            "Toybox games go through toybox_tpu_torch.envs instead") from e
    if state is None:
        state = retro.State.DEFAULT
    env = retro.make(game, state, **kwargs)
    env = StochasticFrameSkip(env, n=4, stickprob=0.25)
    if max_episode_steps is not None:
        env = TimeLimit(env, max_episode_steps=max_episode_steps)
    return env


def wrap_deepmind_retro(env, scale=True, frame_stack=4):
    """DeepMind-style preprocessing for retro games
    (retro_wrappers.py:226-235)."""
    from toybox_tpu_torch.envs.wrappers import (FrameStack,
                                                ScaledFloatFrame, WarpFrame)

    env = WarpFrame(env)
    if scale:
        env = ScaledFloatFrame(env)
    if frame_stack > 1:
        env = FrameStack(env, frame_stack)
    return env

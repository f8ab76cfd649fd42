"""Wrapper-stack utilities (port of toybox_tpu.envs.gym, the reference
toybox/envs/gym.py:40-76)."""

from __future__ import annotations

from toybox_tpu_torch.envs.atari.base import ToyboxBaseEnv, gym


def get_turtle(env):
    """Unwrap a gym wrapper stack to the innermost env."""
    while True:
        if isinstance(env, gym.wrappers.TimeLimit):
            env = env.env
        elif isinstance(env, ToyboxBaseEnv):
            return env
        elif isinstance(env, gym.Wrapper):
            env = env.env
        elif isinstance(env, gym.Env):
            return env
        else:
            raise ValueError("Can't unwrap", env)


def _reset_deep_kludge(env, timeout):
    """Deep-reset every layer, overriding TimeLimit's max steps."""
    while True:
        env.reset()
        if isinstance(env, gym.wrappers.TimeLimit):
            env._max_episode_steps = timeout
            env = env.env
        elif isinstance(env, ToyboxBaseEnv):
            return env
        elif isinstance(env, gym.Wrapper):
            env = env.env
        elif isinstance(env, gym.Env):
            return env
        else:
            raise ValueError("Can't unwrap", env)

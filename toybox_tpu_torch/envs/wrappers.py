"""Single-env wrapper stack (port of toybox_tpu.envs.wrappers): the
reference's vendored baselines/common/atari_wrappers.py on gymnasium.

The standard DeepMind stack (NoopResetEnv, FireResetEnv, EpisodicLifeEnv,
MaxAndSkipEnv, ClipRewardEnv, WarpFrame, FrameStack / LazyFrames),
``SampleEnvs`` (per-episode weighted sampling between envs, the
Toybox/ALE mixed-training mechanism), ``wrap_deepmind`` and
``make_atari``, which takes the reference env ids and builds the port's
envs (``envs.gym_id``). The batched path does these as tensor ops in
``envs/pipeline.py``; this module is the ecosystem-compatible single-env
form. Without gymnasium it still imports (its classes then derive from
``object`` and cannot be used).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from toybox_tpu_torch.envs import gym_id
from toybox_tpu_torch.envs.atari.base import gym, spaces


def _gym_base(name: str):
    return getattr(gym, name) if gym is not None else object


class NoopResetEnv(_gym_base("Wrapper")):
    """Random number of NOOPs on reset (atari_wrappers.py:108-135)."""

    def __init__(self, env, noop_max=30):
        super().__init__(env)
        self.noop_max = noop_max
        self.noop_action = 0
        assert env.unwrapped.get_action_meanings()[0] == "NOOP"

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        noops = int(self.np_random.integers(1, self.noop_max + 1))
        for _ in range(noops):
            obs, _, term, trunc, info = self.env.step(self.noop_action)
            if term or trunc:
                obs, info = self.env.reset(**kwargs)
        return obs, info


class FireResetEnv(_gym_base("Wrapper")):
    """Press FIRE on reset for games that need a serve
    (atari_wrappers.py:137-155)."""

    def __init__(self, env):
        super().__init__(env)
        meanings = env.unwrapped.get_action_meanings()
        assert meanings[1] == "FIRE"
        assert len(meanings) >= 3

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        obs, _, term, trunc, _ = self.env.step(1)
        if term or trunc:
            self.env.reset(**kwargs)
        obs, _, term, trunc, _ = self.env.step(2)
        if term or trunc:
            obs, info = self.env.reset(**kwargs)
            return obs, info
        return obs, {}


class EpisodicLifeEnv(_gym_base("Wrapper")):
    """End episodes on life loss; only truly reset when the game is over
    (atari_wrappers.py:157-191)."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self.was_real_done = term or trunc
        lives = self.env.unwrapped.ale.lives()
        if 0 < lives < self.lives:
            term = True
        self.lives = lives
        return obs, reward, term, trunc, info

    def reset(self, **kwargs):
        if self.was_real_done:
            obs, info = self.env.reset(**kwargs)
        else:
            obs, _, _, _, info = self.env.step(0)
        self.lives = self.env.unwrapped.ale.lives()
        return obs, info


class MaxAndSkipEnv(_gym_base("Wrapper")):
    """Repeat the action `skip` frames, max-pooling the last two
    (atari_wrappers.py:193-216)."""

    def __init__(self, env, skip=4):
        super().__init__(env)
        self._obs_buffer = np.zeros((2,) + env.observation_space.shape,
                                    dtype=np.uint8)
        self._skip = skip

    def step(self, action):
        total_reward = 0.0
        term = trunc = False
        info = {}
        for i in range(self._skip):
            obs, reward, term, trunc, info = self.env.step(action)
            if i == self._skip - 2:
                self._obs_buffer[0] = obs
            if i == self._skip - 1:
                self._obs_buffer[1] = obs
            total_reward += reward
            if term or trunc:
                break
        return (self._obs_buffer.max(axis=0), total_reward, term, trunc,
                info)


class ClipRewardEnv(_gym_base("RewardWrapper")):
    """Sign-clip rewards (atari_wrappers.py:221-228)."""

    def reward(self, reward):
        return float(np.sign(reward))


class WarpFrame(_gym_base("ObservationWrapper")):
    """84x84 warp. Skips RGB->gray when frames are already single-channel
    — Toybox renders grayscale directly (atari_wrappers.py:230-244)."""

    def __init__(self, env, width=84, height=84):
        super().__init__(env)
        self.width = width
        self.height = height
        self.observation_space = spaces.Box(
            low=0, high=255, shape=(height, width, 1), dtype=np.uint8)

    def observation(self, frame):
        import cv2
        if frame.ndim == 3 and frame.shape[-1] == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
        elif frame.ndim == 3:
            frame = frame[:, :, 0]
        frame = cv2.resize(frame, (self.width, self.height),
                           interpolation=cv2.INTER_AREA)
        return frame[:, :, None]


class LazyFrames:
    """Share frames between stacked observations
    (atari_wrappers.py:288-315)."""

    def __init__(self, frames):
        self._frames = frames
        self._out = None

    def _force(self):
        if self._out is None:
            self._out = np.concatenate(self._frames, axis=-1)
            self._frames = None
        return self._out

    def __array__(self, dtype=None, copy=None):
        out = self._force()
        if dtype is not None:
            out = out.astype(dtype)
        return out

    def __len__(self):
        return len(self._force())

    def __getitem__(self, i):
        return self._force()[i]


class FrameStack(_gym_base("Wrapper")):
    """Stack the last k observations (atari_wrappers.py:246-286)."""

    def __init__(self, env, k):
        super().__init__(env)
        self.k = k
        self.frames = deque([], maxlen=k)
        shp = env.observation_space.shape
        self.observation_space = spaces.Box(
            low=0, high=255, shape=(shp[0], shp[1], shp[2] * k),
            dtype=env.observation_space.dtype)

    def reset(self, **kwargs):
        ob, info = self.env.reset(**kwargs)
        for _ in range(self.k):
            self.frames.append(ob)
        return self._get_ob(), info

    def step(self, action):
        ob, reward, term, trunc, info = self.env.step(action)
        self.frames.append(ob)
        return self._get_ob(), reward, term, trunc, info

    def _get_ob(self):
        assert len(self.frames) == self.k
        return LazyFrames(list(self.frames))


class ScaledFloatFrame(_gym_base("ObservationWrapper")):

    def __init__(self, env):
        super().__init__(env)
        self.observation_space = spaces.Box(
            low=0, high=1, shape=env.observation_space.shape,
            dtype=np.float32)

    def observation(self, observation):
        return np.array(observation).astype(np.float32) / 255.0


class SampleEnvs(_gym_base("Wrapper")):
    """Per-episode weighted sampling among a list of envs — the
    mixed Toybox/ALE training mechanism (atari_wrappers.py:70-105)."""

    def __init__(self, envs, weights):
        assert len(envs) == len(weights)
        assert abs(sum(weights) - 1.0) < 1e-6
        super().__init__(envs[0])
        self.envs = envs
        self.weights = weights
        self.current = envs[0]

    def sample(self):
        idx = int(np.random.choice(len(self.envs), p=self.weights))
        self.current = self.envs[idx]
        self.env = self.current

    def reset(self, **kwargs):
        self.sample()
        return self.current.reset(**kwargs)

    def step(self, action):
        return self.current.step(action)


def hotpatch_ale() -> bool:
    """Patch the real-ALE AtariEnv.step so it reports the running game
    score in ``info`` — the reference's import-time hotpatch
    (atari_wrappers.py:19-45), which the mixed Toybox/ALE ``SampleEnvs``
    path needs because ALE only exposes per-step reward deltas while the
    Toybox envs report an absolute score.

    Semantics mirror the reference exactly: ``info['score']`` is the
    accumulated score BEFORE this step's reward, and the accumulator
    zeroes on episode end. Guarded: returns False (no-op) when ale_py
    isn't installed; idempotent otherwise.
    """
    try:
        from ale_py.env import AtariEnv  # gymnasium-era ale_py
    except ImportError:
        try:  # legacy layout
            from gym.envs.atari import AtariEnv  # type: ignore
        except ImportError:
            return False

    if getattr(AtariEnv, "_toybox_tpu_score_patch", False):
        return True
    orig_step = AtariEnv.step

    def step(self, action):
        out = orig_step(self, action)
        if len(out) == 5:  # gymnasium: obs, rew, terminated, truncated, info
            obs, reward, terminated, truncated, info = out
            done = bool(terminated) or bool(truncated)
        else:              # legacy gym: obs, rew, done, info
            obs, reward, done, info = out
            terminated, truncated = done, False
        score = getattr(self, "_toybox_tpu_score", 0.0)
        info = dict(info)
        info["score"] = score
        info.setdefault("lives", self.ale.lives())
        self._toybox_tpu_score = 0.0 if done else score + float(reward)
        if len(out) == 5:
            return obs, reward, terminated, truncated, info
        return obs, reward, done, info

    AtariEnv.step = step
    AtariEnv._toybox_tpu_score_patch = True
    return True


TOYBOX_SUFFIX = "ToyboxNoFrameskip-v4"


def get_complement(env_id: str) -> str:
    """Map a Toybox env id to its ALE twin and back
    (atari_wrappers.py:317-322); a namespace is dropped."""
    env_id = env_id.rsplit("/", 1)[-1]
    if "Toybox" in env_id:
        return env_id.replace("Toybox", "")
    return env_id.replace("NoFrameskip", "ToyboxNoFrameskip")


def make_atari(env_id, max_episode_steps=None, sample_weights=None,
               device="cuda"):
    """Env factory (atari_wrappers.py:324-344): NoopReset + MaxAndSkip,
    TimeLimit for Toybox ids, optional SampleEnvs mixing. A Toybox id
    (reference name or the port's namespaced one) builds the port's env
    on ``device``."""
    import gymnasium

    def base(eid):
        if "Toybox" in eid:
            env = gymnasium.make(gym_id(eid), device=device)
        else:
            # a real-ALE twin: needs the score hotpatch (and ale_py)
            if not hotpatch_ale():
                raise ImportError(
                    f"{eid} is a real-ALE env id but ale_py is not "
                    f"installed; install the 'ale' extra or use the "
                    f"Toybox id")
            env = gymnasium.make(eid)
        env = NoopResetEnv(env, noop_max=30)
        env = MaxAndSkipEnv(env, skip=4)
        if max_episode_steps is not None or "Toybox" in eid:
            env = gymnasium.wrappers.TimeLimit(
                env, max_episode_steps=max_episode_steps or 100_000)
        return env

    if sample_weights:
        envs = [base(env_id), base(get_complement(env_id))]
        return SampleEnvs(envs, sample_weights)
    return base(env_id)


def wrap_deepmind(env, episode_life=True, clip_rewards=True, frame_stack=False,
                  scale=False):
    """DeepMind-style final stack (atari_wrappers.py:346-360)."""
    if episode_life:
        env = EpisodicLifeEnv(env)
    if "FIRE" in env.unwrapped.get_action_meanings()[:2]:
        env = FireResetEnv(env)
    env = WarpFrame(env)
    if scale:
        env = ScaledFloatFrame(env)
    if clip_rewards:
        env = ClipRewardEnv(env)
    if frame_stack:
        env = FrameStack(env, 4)
    return env

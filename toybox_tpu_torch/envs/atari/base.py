"""Gym-compatible single-env layer (port of toybox_tpu.envs.atari.base).

Mirrors reference toybox/envs/atari/base.py (MockALE duck-type,
ToyboxBaseEnv semantics: obs space from engine dims x {1,3,4} channels,
two-stage seeding, reward = max(score delta, 0), done = ALE game-over
(lives <= 0), info = {lives, score, cached_state on game-over}, reset
caches the outgoing state JSON then starts a new game), over the port's
``Toybox`` facade: observations are numpy arrays read back from the
facade's device.

Built on gymnasium: ``step`` returns the 5-tuple (obs, reward,
terminated, truncated, info) and ``reset`` accepts ``seed=``/returns
(obs, info); ``LegacyStepWrapper`` gives the 4-tuple surface. Without
gymnasium (the card machine has none) this module still imports, and
``gym`` is None.
"""

from __future__ import annotations

import hashlib

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:
    gym = None
    spaces = None

from toybox_tpu_torch.core.actions import ACTION_MEANING
from toybox_tpu_torch.ctoybox import Toybox


class MockALE:
    """Duck-types the ``ale`` attribute baselines-style wrappers expect
    (reference toybox/envs/atari/base.py:15-35). ``get_score`` is a Toybox
    extension that real ALE lacks."""

    def __init__(self, toybox: Toybox):
        self.toybox = toybox

    def lives(self):
        return self.toybox.get_lives()

    def get_score(self):
        return self.toybox.get_score()

    def game_over(self):
        # baselines/atari_py semantics, not what videogames would expect
        return self.toybox.get_lives() <= 0

    def saveScreenPNG(self, name):
        if isinstance(name, bytes):
            name = name.decode("utf-8")
        self.toybox.save_frame_image(name, grayscale=False)


def _hash_seed(seed: int) -> int:
    """Stable uint31 derivation of a secondary seed (the role of gym's
    removed ``seeding.hash_seed``, reference base.py:94-97)."""
    h = hashlib.sha256(str(seed).encode()).digest()
    return int.from_bytes(h[:4], "little") % 2**31


class ToyboxBaseEnv(gym.Env if gym is not None else object):
    metadata = {"render_modes": ["human", "rgb_array"]}

    def __init__(self, toybox: Toybox, frameskip=(2, 5),
                 repeat_action_probability=0.0, grayscale=True, alpha=False,
                 actions=None, render_mode=None):
        assert toybox.rstate is not None
        self.toybox = toybox
        self.cached_state = None
        self.score = toybox.get_score()
        self.render_mode = render_mode
        self.frameskip = frameskip
        self.repeat_action_probability = repeat_action_probability
        self._last_action = 0
        self.ale = MockALE(toybox)
        self.np_random = np.random.default_rng(0)

        if actions is None:
            actions = toybox.get_legal_action_set()
        self._action_set = list(actions)
        self._obs_type = "image"
        self._rgba = 1 if grayscale else 4 if alpha else 3
        self._height = toybox.get_height()
        self._width = toybox.get_width()
        self._dim = (self._height, self._width, self._rgba)

        self.reward_range = (0, float("inf"))
        self.action_space = spaces.Discrete(len(self._action_set))
        self.observation_space = spaces.Box(
            low=0, high=255, shape=self._dim, dtype=np.uint8)

    # -- seeding (reference base.py:84-98 two-stage scheme) ----------------
    def seed(self, seed=None):
        seed1 = (seed if seed is not None
                 else np.random.SeedSequence().entropy % 2**31)
        self.np_random = np.random.default_rng(seed1)
        seed2 = _hash_seed(int(seed1) + 1)
        self.toybox.set_seed(seed2)
        self.toybox.new_game()
        return [seed1, seed2]

    def get_action_meanings(self):
        return list(ACTION_MEANING.values())

    def _get_obs(self):
        obs = self.toybox.get_state()
        if self._rgba == 3:
            obs = self.toybox.get_rgba_frame()[:, :, :-1]
        return np.asarray(obs)

    def _frames_this_step(self):
        fs = self.frameskip
        if isinstance(fs, (tuple, list)):
            lo, hi = fs
            if hi <= lo:
                return max(1, lo)
            return int(self.np_random.integers(lo, hi))
        return max(1, int(fs))

    def step(self, action_index):
        assert action_index < len(self._action_set)
        info = {}

        if (self.repeat_action_probability > 0
                and self.np_random.random() < self.repeat_action_probability):
            action_index = self._last_action
        self._last_action = action_index

        for _ in range(self._frames_this_step()):
            self.toybox.apply_ale_action(self._action_set[action_index])

        if self.ale.game_over():
            info["cached_state"] = self.toybox.to_state_json()

        obs = self._get_obs()
        score = self.toybox.get_score()
        reward = max(score - self.score, 0)
        self.score = score
        done = self.ale.game_over()
        info["lives"] = self.toybox.get_lives()
        info["score"] = 0 if done else self.score
        return obs, reward, done, False, info

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.seed(seed)
        self.cached_state = self.toybox.to_state_json()
        self.toybox.new_game()
        self.score = self.toybox.get_score()
        return self._get_obs(), {"lives": self.toybox.get_lives()}

    def render(self):
        if self.render_mode == "rgb_array" or self.render_mode is None:
            return self.toybox.get_rgb_frame()
        if self.render_mode == "human":
            try:
                import pygame
            except ImportError as e:
                raise RuntimeError("human render requires pygame") from e
            frame = self.toybox.get_rgb_frame()
            if not hasattr(self, "_screen"):
                pygame.init()
                self._screen = pygame.display.set_mode(
                    (frame.shape[1], frame.shape[0]))
            surf = pygame.surfarray.make_surface(frame.swapaxes(0, 1))
            self._screen.blit(surf, (0, 0))
            pygame.display.flip()
            return True

    def close(self):
        if getattr(self, "_screen", None) is not None:
            import pygame
            pygame.quit()
            self._screen = None
        self.toybox = None


class LegacyStepWrapper(gym.Wrapper if gym is not None else object):
    """Old-gym 4-tuple surface for code expecting (obs, rew, done, info)."""

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(action)
        return obs, rew, term or trunc, info

    def reset(self, **kwargs):
        obs, _ = self.env.reset(**kwargs)
        return obs

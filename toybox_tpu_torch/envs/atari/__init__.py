"""Per-game gym env classes (port of toybox_tpu.envs.atari; the reference
toybox/envs/atari/{breakout,amidar,space_invaders,gridworld}.py thin
constructors; frameskip default (2,5), grayscale default True). Each
holds one ``Toybox`` on ``device`` (``cuda`` unless the caller asks for
``cpu``)."""

from toybox_tpu_torch.ctoybox import Toybox
from toybox_tpu_torch.envs.atari.base import (LegacyStepWrapper, MockALE,
                                              ToyboxBaseEnv)

__all__ = ["BreakoutEnv", "AmidarEnv", "SpaceInvadersEnv", "GridWorldEnv",
           "LegacyStepWrapper", "MockALE", "ToyboxBaseEnv"]


def _game_env(game: str, default_frameskip):
    class GameEnv(ToyboxBaseEnv):

        def __init__(self, frameskip=default_frameskip,
                     repeat_action_probability=0.0, grayscale=True,
                     alpha=False, render_mode=None, device="cuda"):
            super().__init__(Toybox(game, grayscale=grayscale,
                                    device=device),
                             frameskip, repeat_action_probability,
                             grayscale=grayscale, alpha=alpha,
                             render_mode=render_mode)

    return GameEnv


class BreakoutEnv(_game_env("breakout", (2, 5))):
    pass


class AmidarEnv(_game_env("amidar", (2, 5))):
    pass


class SpaceInvadersEnv(_game_env("space_invaders", (2, 5))):
    pass


class GridWorldEnv(_game_env("gridworld", (0, 0))):
    pass

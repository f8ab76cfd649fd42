"""ALE action constants at the reference's module path (port of
toybox_tpu.envs.atari.constants); the definitions live in
toybox_tpu_torch.core.actions."""

from toybox_tpu_torch.core.actions import (ACTION_LOOKUP, ACTION_MEANING,
                                           DOWN_STR, DOWNFIRE_STR, FIRE_STR,
                                           LEFT_STR, LEFTFIRE_STR, NOOP_STR,
                                           RIGHT_STR, RIGHTFIRE_STR, UP_STR,
                                           UPFIRE_STR)

__all__ = ["ACTION_MEANING", "ACTION_LOOKUP", "NOOP_STR", "FIRE_STR",
           "UP_STR", "RIGHT_STR", "LEFT_STR", "DOWN_STR", "UPFIRE_STR",
           "RIGHTFIRE_STR", "LEFTFIRE_STR", "DOWNFIRE_STR"]

"""Core value types, RNG and action decoding."""

from toybox_tpu_torch.core import actions, jsonutil, rng, types
from toybox_tpu_torch.core.actions import (ACTION_LOOKUP, ACTION_MEANING,
                                           LEGAL_ACTIONS, ale_to_input)
from toybox_tpu_torch.core.types import Direction, Input, rgba

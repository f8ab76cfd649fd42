"""Core value types (port of toybox_tpu.core.types, ``Input`` only)."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Input"]


@dataclasses.dataclass(frozen=True)
class Input:
    """Per-frame input struct, a mirror of ctoybox.Input.

    Fields are python bools or bool tensors with a leading env axis, so an
    Input can be built on the host or decoded from a batch of ALE actions.
    """

    left: Any = False
    right: Any = False
    up: Any = False
    down: Any = False
    button1: Any = False
    button2: Any = False

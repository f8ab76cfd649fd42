"""Core value types (port of toybox_tpu.core.types: ``Input``, the
``Direction`` string enum, ``DIRECTIONS`` and ``rgba``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["Input", "Direction", "rgba", "DIRECTIONS"]


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


class Direction:
    """String direction enum (the reference's interventions Direction)."""

    Up = "Up"
    Down = "Down"
    Left = "Left"
    Right = "Right"

    ALL = (Up, Down, Left, Right)

    # Integer codes used inside device state arrays.
    CODE = {Up: 0, Down: 1, Left: 2, Right: 3}
    FROM_CODE = {v: k for k, v in CODE.items()}

    # Unit vectors in tile space, indexed by code: (dx, dy).
    VECTORS = ((0, -1), (0, 1), (-1, 0), (1, 0))


DIRECTIONS = Direction.ALL


def rgba(r: int, g: int, b: int, a: int = 255, device=None) -> torch.Tensor:
    """An RGBA color, u8[4]."""
    return torch.tensor([r, g, b, a], dtype=torch.uint8, device=device)

"""Batched interventions: functional updates over the env axis (port of
toybox_tpu.interventions.batched).

The single-env intervention API decodes one env's state to typed Python
objects, mutates and re-encodes. The port's engines hold N envs as one
[N, ...] state dataclass, so the same property paths ('bricks[5].alive',
'paddle.position.x') resolve to (field, index) coordinates of that
dataclass, and an intervention becomes one masked select over all envs:

    states = batched_set(states, "breakout", "bricks[5].alive", False)
    states = batched_set(states, "breakout", "paddle.position.x", xs,
                         env_mask=done)   # per-env values, masked

Reads go through batched_get. Neither writes into the tensors it is
given: the engines' states share broadcast views between envs.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from toybox_tpu_torch.interventions.core import parse_property_access

# path template -> state field; an ``int`` segment takes an entity index
_BREAKOUT = {
    ("score",): "score",
    ("lives",): "lives",
    ("level",): "level",
    ("is_dead",): "is_dead",
    ("reset",): "reset",
    ("paddle", "position", "x"): "paddle_x",
    ("paddle", "position", "y"): "paddle_y",
    ("paddle", "velocity", "x"): "paddle_vx",
    ("paddle_width",): "paddle_width",
    ("paddle_speed",): "paddle_speed",
    ("ball_radius",): "ball_radius",
    ("balls", int, "position", "x"): "ball_x",
    ("balls", int, "position", "y"): "ball_y",
    ("balls", int, "velocity", "x"): "ball_vx",
    ("balls", int, "velocity", "y"): "ball_vy",
    ("bricks", int, "alive"): "brick_alive",
    ("bricks", int, "destructible"): "brick_destructible",
    ("bricks", int, "points"): "brick_points",
    ("bricks", int, "depth"): "brick_depth",
    ("bricks", int, "color"): "brick_color",
    ("bricks", int, "position", "x"): "brick_x",
    ("bricks", int, "position", "y"): "brick_y",
    ("bricks", int, "size", "x"): "brick_w",
    ("bricks", int, "size", "y"): "brick_h",
}

_AMIDAR = {
    ("score",): "score",
    ("lives",): "lives",
    ("level",): "level",
    ("jumps",): "jumps",
    ("jump_timer",): "jump_timer",
    ("chase_timer",): "chase_timer",
    ("player", "position", "x"): "player_x",
    ("player", "position", "y"): "player_y",
    ("enemies", int, "position", "x"): "enemy_x",
    ("enemies", int, "position", "y"): "enemy_y",
    ("enemies", int, "caught"): "enemy_caught",
}

_SPACE_INVADERS = {
    ("score",): "score",
    ("lives",): "lives",
    ("level",): "level",
    ("life_display_timer",): "life_display_timer",
    ("enemy_shot_delay",): "enemy_shot_delay",
    ("ship", "x"): "ship_x",
    ("ship", "y"): "ship_y",
    ("ship", "alive"): "ship_alive",
    ("ufo", "x"): "ufo_x",
    ("ufo", "y"): "ufo_y",
    ("ufo", "appearance_counter"): "ufo_appearance_counter",
    ("enemies", int, "alive"): "enemy_alive",
    ("enemies", int, "x"): "enemy_x",
    ("enemies", int, "y"): "enemy_y",
}

_TABLES = {
    "breakout": _BREAKOUT,
    "amidar": _AMIDAR,
    "space_invaders": _SPACE_INVADERS,
}


def _resolve(game: str, path: str):
    """'bricks[5].alive' -> (field_name, entity_index | None)."""
    parts = parse_property_access(path)
    shape = tuple(int if isinstance(p, int) else p for p in parts)
    table = _TABLES[game]
    if shape not in table:
        raise KeyError(
            f"no batched mapping for {path!r} in {game}; "
            f"known shapes: {sorted(str(k) for k in table)}")
    idx = next((p for p in parts if isinstance(p, int)), None)
    return table[shape], idx


def batched_get(states, game: str, path: str) -> torch.Tensor:
    """Read a property across all envs: [N] (or [N, ...])."""
    field, idx = _resolve(game, path)
    arr = getattr(states, field)
    return arr if idx is None else arr[:, idx]


def batched_set(states, game: str, path: str, value,
                env_mask: Optional[Any] = None):
    """A new state with the property set across the env axis.

    value: a scalar (every env) or per-env [N] values, cast to the field's
    dtype. env_mask: optional bool[N] restricting which envs are edited.
    """
    field, idx = _resolve(game, path)
    arr = getattr(states, field)
    value = torch.as_tensor(value, device=arr.device).to(arr.dtype)
    if idx is None:
        new = value.expand(arr.shape)
    else:
        new = arr.clone()
        new[:, idx] = value
    if env_mask is not None:
        m = torch.as_tensor(env_mask, device=arr.device).reshape(
            (-1,) + (1,) * (arr.dim() - 1))
        new = torch.where(m, new, arr)
    return states.replace(**{field: new})

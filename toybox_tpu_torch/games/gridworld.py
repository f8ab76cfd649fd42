"""Gridworld engine in PyTorch (port of toybox_tpu.games.gridworld).

A char-coded grid of tiles, each with a color, a reward, and goal and
walkable flags; a consumed reward tile turns into ``reward_becomes`` and
reaching a goal ends the game. One action moves the player one tile.

The state is a struct of tensors with a leading env axis, the same fields
as the JAX ``State``: ``grid[N, H, W]`` holds tile codes, and the tile
tables (``tile_color[N, 8, 4]`` etc.) live in the state, where
interventions can write them. Tile codes index the *sorted* tile chars of
the config JSON, padded to ``MAX_TILE_TYPES``. ``rng`` is unused by the
dynamics and kept for the engines' common protocol. Gridworld's config has
no ``rand``: ``new_game`` with no seeds starts one game seeded with 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toybox_tpu_torch.core import jsonutil, rng
from toybox_tpu_torch.core.actions import LEGAL_ACTIONS as _LEGAL
from toybox_tpu_torch.core.types import Input
from toybox_tpu_torch.games.common import F32, U8, rect_mask

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool

GAME_NAME = "gridworld"
LEGAL_ACTIONS = _LEGAL["gridworld"]

MAX_TILE_TYPES = 8
TILE_PX = 16  # render scale: one grid cell = 16x16 px

_DEFAULT_CONFIG_JSON = {
    "reward_becomes": "0",
    "grid": ["111111111", "1000R0001", "101111101", "100010001",
             "10001R111", "1000100G1", "111111111"],
    "player_start": [2, 4],
    "player_color": {"r": 255, "g": 0, "b": 0, "a": 255},
    "game_size": [9, 7],
    "tiles": {
        "0": {"color": {"r": 255, "g": 255, "b": 255, "a": 255},
              "goal": False, "reward": 0, "walkable": True},
        "1": {"color": {"r": 0, "g": 0, "b": 0, "a": 255},
              "goal": False, "reward": 0, "walkable": False},
        "G": {"color": {"r": 0, "g": 255, "b": 0, "a": 255},
              "goal": True, "reward": 10, "walkable": True},
        "R": {"color": {"r": 255, "g": 255, "b": 0, "a": 255},
              "goal": False, "reward": 1, "walkable": True},
    },
}

# The default grid's frame size; ``render`` draws each state at its own
# grid's size.
WIDTH = len(_DEFAULT_CONFIG_JSON["grid"][0]) * TILE_PX
HEIGHT = len(_DEFAULT_CONFIG_JSON["grid"]) * TILE_PX


@dataclasses.dataclass(frozen=True)
class Config:
    device: torch.device
    grid: torch.Tensor           # i32[H, W] initial tile codes
    player_start: torch.Tensor   # i32[2] (x, y)
    player_color: torch.Tensor   # u8[4]
    reward_becomes: int          # tile code
    tile_color: torch.Tensor     # u8[T, 4]
    tile_goal: torch.Tensor      # bool[T]
    tile_reward: torch.Tensor    # i32[T]
    tile_walkable: torch.Tensor  # bool[T]
    tile_chars: tuple = ()       # the char of each code


@dataclasses.dataclass(frozen=True)
class State:
    grid: torch.Tensor           # i32[N, H, W]
    player: torch.Tensor         # i32[N, 2] (x, y)
    score: torch.Tensor          # i32[N]
    lives: torch.Tensor          # i32[N] (1 until the goal)
    level: torch.Tensor          # i32[N]
    game_over: torch.Tensor      # bool[N]
    reward_becomes: torch.Tensor  # i32[N]
    player_color: torch.Tensor   # u8[N, 4]
    tile_color: torch.Tensor     # u8[N, T, 4]
    tile_goal: torch.Tensor      # bool[N, T]
    tile_reward: torch.Tensor    # i32[N, T]
    tile_walkable: torch.Tensor  # bool[N, T]
    rng: torch.Tensor            # int64[N, 4] u32 words (unused)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(State))

# The tile tables are state (intervenable), so no field is step-constant:
# the batched env's auto-reset selects every field.
STEP_CONSTANT_FIELDS = ()


def _tile_tables(tiles) -> tuple:
    """(color u8[T, 4], goal bool[T], reward i32[T], walkable bool[T]) of
    tile dicts in code order, padded to MAX_TILE_TYPES."""
    tc = np.zeros((MAX_TILE_TYPES, 4), np.uint8)
    tg = np.zeros(MAX_TILE_TYPES, bool)
    tr = np.zeros(MAX_TILE_TYPES, np.int32)
    tw = np.zeros(MAX_TILE_TYPES, bool)
    for i, t in enumerate(tiles):
        tc[i] = jsonutil.color_from_json(t["color"])
        tg[i] = t["goal"]
        tr[i] = t["reward"]
        tw[i] = t["walkable"]
    return tc, tg, tr, tw


def config_from_json(d: dict, device="cuda") -> Config:
    device = torch.device(device)
    chars = sorted(d["tiles"].keys())
    assert len(chars) <= MAX_TILE_TYPES
    code = {c: i for i, c in enumerate(chars)}
    grid = np.array([[code[c] for c in row] for row in d["grid"]], np.int32)
    tc, tg, tr, tw = _tile_tables(d["tiles"][c] for c in chars)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return Config(
        device=device,
        grid=t(grid),
        player_start=t(np.asarray(d["player_start"], np.int32)),
        player_color=t(jsonutil.color_from_json(d["player_color"])),
        reward_becomes=code[d["reward_becomes"]],
        tile_color=t(tc), tile_goal=t(tg), tile_reward=t(tr),
        tile_walkable=t(tw), tile_chars=tuple(chars))


def default_config(device="cuda") -> Config:
    return config_from_json(_DEFAULT_CONFIG_JSON, device)


def _tile_json(color, goal, reward, walkable) -> dict:
    return {"color": jsonutil.color_to_json(color), "goal": bool(goal),
            "reward": int(reward), "walkable": bool(walkable)}


def config_to_json(config: Config) -> dict:
    """The reference JSON config: ``reward_becomes`` as its tile char."""
    chars = config.tile_chars
    grid = config.grid.cpu().numpy()
    tables = [x.cpu().numpy() for x in (
        config.tile_color, config.tile_goal, config.tile_reward,
        config.tile_walkable)]
    return {
        "reward_becomes": chars[config.reward_becomes],
        "grid": ["".join(chars[v] for v in row) for row in grid],
        "player_start": config.player_start.cpu().tolist(),
        "player_color": jsonutil.color_to_json(config.player_color.cpu()),
        "game_size": [grid.shape[1], grid.shape[0]],
        "tiles": {c: _tile_json(*(x[i] for x in tables))
                  for i, c in enumerate(chars)},
    }


def new_game(config: Config, seeds: torch.Tensor | None = None) -> State:
    """Fresh games, one per u32 seed in ``seeds`` [N]; with no seeds, one
    game seeded with 0 (the config has no rng of its own)."""
    dev = config.device
    if seeds is None:
        seeds = torch.zeros(1, dtype=I64, device=dev)
    keys = rng.seed(torch.as_tensor(seeds, device=dev))
    n = keys.shape[0]

    def rows(v):
        return v.expand((n,) + tuple(v.shape))

    zero = torch.zeros(n, dtype=I32, device=dev)
    return State(
        grid=rows(config.grid), player=rows(config.player_start),
        score=zero, lives=torch.ones(n, dtype=I32, device=dev), level=zero,
        game_over=torch.zeros(n, dtype=BOOL, device=dev),
        reward_becomes=torch.full((n,), config.reward_becomes, dtype=I32,
                                  device=dev),
        player_color=rows(config.player_color),
        tile_color=rows(config.tile_color), tile_goal=rows(config.tile_goal),
        tile_reward=rows(config.tile_reward),
        tile_walkable=rows(config.tile_walkable), rng=keys)


def step(config: Config, s: State, inp: Input) -> State:
    n, h, w = s.grid.shape
    dev = s.grid.device
    env = torch.arange(n, device=dev)

    def b(v):
        return torch.as_tensor(v, device=dev).to(I32).expand(n)

    dx = b(inp.right) - b(inp.left)
    dy = b(inp.down) - b(inp.up)
    # one axis at a time; vertical wins if both are pressed
    dx = dx * (dy == 0).to(I32)
    px, py = s.player[:, 0], s.player[:, 1]
    nx = (px + dx).clamp(0, w - 1)
    ny = (py + dy).clamp(0, h - 1)
    code = s.grid[env, ny.long(), nx.long()].long()
    ok = s.tile_walkable[env, code] & ~s.game_over
    nx = torch.where(ok, nx, px)
    ny = torch.where(ok, ny, py)
    code = s.grid[env, ny.long(), nx.long()].long()
    reward = s.tile_reward[env, code] * ok.to(I32)
    goal = ok & s.tile_goal[env, code]
    consumed = ok & (reward > 0) & ~s.tile_goal[env, code]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    at = ((ys == ny[:, None, None]) & (xs == nx[:, None, None])
          & consumed[:, None, None])
    game_over = s.game_over | goal
    return s.replace(
        grid=torch.where(at, s.reward_becomes[:, None, None], s.grid),
        player=torch.stack([nx, ny], -1),
        score=s.score + reward,
        lives=(~game_over).to(I32),
        game_over=game_over,
    )


def render(config: Config, s: State) -> torch.Tensor:
    """RGBA frames u8[N, H * TILE_PX, W * TILE_PX, 4] at the state's own
    grid size: each cell in its tile's color, the player's cell in the
    player's color."""
    n, h, w = s.grid.shape
    dev = s.grid.device
    env = torch.arange(n, device=dev)[:, None, None]
    cells = s.tile_color[env, s.grid.long()]               # u8[N, h, w, 4]
    img = cells.repeat_interleave(TILE_PX, 1).repeat_interleave(TILE_PX, 2)
    px = (s.player[:, 0] * TILE_PX).to(F32)
    py = (s.player[:, 1] * TILE_PX).to(F32)
    m = rect_mask(h * TILE_PX, w * TILE_PX, px, py, px + TILE_PX,
                  py + TILE_PX, dev)
    return torch.where(m[..., None], s.player_color[:, None, None, :], img)


def state_to_json(config: Config, s: State, i: int = 0) -> dict:
    """The reference JSON state of env ``i``: ``reward_becomes`` as its
    tile code, the tiles of the config's chars in code order."""
    h = {f: getattr(s, f)[i].cpu() for f in FIELDS}
    tables = [h[f].numpy() for f in ("tile_color", "tile_goal",
                                     "tile_reward", "tile_walkable")]
    return {
        "reward_becomes": int(h["reward_becomes"]),
        "grid": h["grid"].tolist(),
        "score": int(h["score"]),
        "player_color": jsonutil.color_to_json(h["player_color"]),
        "game_over": bool(h["game_over"]),
        "player": h["player"].tolist(),
        "tiles": [_tile_json(*(x[k] for x in tables))
                  for k in range(len(config.tile_chars))],
    }


def state_from_json(config: Config, d: dict) -> State:
    """A batch of one game on ``config.device`` from the reference JSON
    state; lives follow game_over and the rng is seeded with 0, as the
    JAX codec does."""
    tc, tg, tr, tw = _tile_tables(d["tiles"])
    go = bool(d["game_over"])
    dev = config.device

    def one(v, dtype):
        return torch.as_tensor(np.asarray(v), device=dev).to(dtype)[None]

    return State(
        grid=one(np.array(d["grid"], np.int32), I32),
        player=one(d["player"], I32), score=one(d["score"], I32),
        lives=one(0 if go else 1, I32), level=one(0, I32),
        game_over=one(go, BOOL),
        reward_becomes=one(d["reward_becomes"], I32),
        player_color=one(jsonutil.color_from_json(d["player_color"]), U8),
        tile_color=one(tc, U8), tile_goal=one(tg, BOOL),
        tile_reward=one(tr, I32), tile_walkable=one(tw, BOOL),
        rng=rng.seed(torch.zeros(1, dtype=I64, device=dev)))


def schema() -> dict:
    return {
        "type": "object",
        "required": ["reward_becomes", "grid", "score", "player_color",
                     "game_over", "player", "tiles"],
    }


def query(config: Config, s: State, name: str, args=None, i: int = 0):
    raise ValueError(f"unknown gridworld query: {name}")


def lives(s: State) -> torch.Tensor:
    return s.lives


def score(s: State) -> torch.Tensor:
    return s.score

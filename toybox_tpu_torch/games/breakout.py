"""Breakout engine in PyTorch (port of toybox_tpu.games.breakout).

The state is a struct of tensors with a leading env axis: ``score[N]``,
``ball_x[N, MAX_BALLS]``, ``brick_alive[N, MAX_BRICKS]`` and so on, the
same fields as the JAX ``State``. ``step`` advances every env by one
engine frame with the same arithmetic, in the same order, as the JAX
step, so seeded trajectories and their state-JSON digests are identical.

dtypes: i32 fields stay int32, f32 fields float32, bools bool. The two
u32 fields (``rng`` words and packed ``brick_color``) are held in int64,
masked to 32 bits (see ``core/rng.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toybox_tpu_torch.core import jsonutil, rng
from toybox_tpu_torch.core.actions import LEGAL_ACTIONS as _LEGAL
from toybox_tpu_torch.core.types import Input
from toybox_tpu_torch.games.common import (F32, pack_color, rect_mask,
                                           unpack_color)

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool

GAME_NAME = "breakout"
WIDTH = 240
HEIGHT = 160
LEGAL_ACTIONS = _LEGAL["breakout"]

LEFT_WALL = 12.0
RIGHT_WALL = 228.0
TOP_WALL = 15.0
BOTTOM = float(HEIGHT)
PADDLE_HEIGHT = 4.0
PADDLE_Y = 143.0

N_ROWS = 6
N_COLS = 18
MAX_BRICKS = 144
DEFAULT_BRICKS = N_ROWS * N_COLS
MAX_BALLS = 4
SUBSTEPS = 2

# Brick raster geometry (render): bricks draw at their (row, col) cells.
MAX_RENDER_ROWS = 24
BRICK_BAND_Y0 = 43
BRICK_BAND_H = MAX_RENDER_ROWS * 4
BRICK_CELL_H, BRICK_CELL_W = 4, 12

_DEFAULT_CONFIG_JSON = {
    "paddle_discrete_segments": 5,
    "ball_start_positions": [
        {"x": 24.0, "y": 80.0, "angle_degrees": 30.0},
        {"x": 120.0, "y": 80.0, "angle_degrees": 30.0},
        {"x": 120.0, "y": 80.0, "angle_degrees": 150.0},
        {"x": 216.0, "y": 80.0, "angle_degrees": 150.0},
    ],
    "start_lives": 5,
    "row_scores": [7, 7, 4, 4, 1, 1],
    "ball_speed_row_depth": 3,
    "ball_speed_slow": 2.0,
    "ball_speed_fast": 4.0,
    "bg_color": {"r": 0, "g": 0, "b": 0, "a": 255},
    "frame_color": {"r": 144, "g": 144, "b": 144, "a": 255},
    "paddle_color": {"r": 200, "g": 72, "b": 72, "a": 255},
    "ball_color": {"r": 200, "g": 72, "b": 72, "a": 255},
    "row_colors": [
        {"r": 200, "g": 72, "b": 72, "a": 255},
        {"r": 198, "g": 108, "b": 58, "a": 255},
        {"r": 180, "g": 122, "b": 48, "a": 255},
        {"r": 162, "g": 162, "b": 42, "a": 255},
        {"r": 72, "g": 160, "b": 72, "a": 255},
        {"r": 66, "g": 72, "b": 200, "a": 255},
    ],
    "rand": {"state": [11972506314117325106, 12454289224450883102]},
}


def _f32(v) -> float:
    """A python float that holds exactly the f32 value of ``v``."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class Config:
    """Game constants. Small per-table tensors live on ``device``; scalars
    are python numbers holding f32/i32 values."""
    device: torch.device
    ball_start_x: torch.Tensor       # f32[4]
    ball_start_y: torch.Tensor       # f32[4]
    ball_start_ux: torch.Tensor      # f32[4] unit serve direction
    ball_start_uy: torch.Tensor      # f32[4]
    seg_cos: torch.Tensor            # f32[nseg] paddle reflection
    seg_sin: torch.Tensor            # f32[nseg]
    start_lives: int
    row_scores: torch.Tensor         # i32[N_ROWS]
    row_colors: torch.Tensor         # int64[N_ROWS] packed u32
    ball_speed_row_depth: int
    ball_speed_slow: float
    ball_speed_fast: float
    bg_color: int                    # packed u32
    frame_color: int
    paddle_color: int
    ball_color: int


@dataclasses.dataclass(frozen=True)
class State:
    score: torch.Tensor        # i32[N]
    lives: torch.Tensor        # i32[N]
    level: torch.Tensor        # i32[N]
    rng: torch.Tensor          # int64[N, 4] u32 words
    is_dead: torch.Tensor      # bool[N]
    reset: torch.Tensor        # bool[N] (ball waiting to be served)
    paddle_x: torch.Tensor     # f32[N] (center x)
    paddle_y: torch.Tensor     # f32[N]
    paddle_vx: torch.Tensor    # f32[N]
    paddle_width: torch.Tensor  # f32[N]
    paddle_speed: torch.Tensor  # f32[N]
    ball_radius: torch.Tensor   # f32[N]
    ball_x: torch.Tensor       # f32[N, MAX_BALLS]
    ball_y: torch.Tensor
    ball_vx: torch.Tensor
    ball_vy: torch.Tensor
    ball_alive: torch.Tensor   # bool[N, MAX_BALLS]
    brick_x: torch.Tensor      # f32[N, MAX_BRICKS] top-left
    brick_y: torch.Tensor
    brick_w: torch.Tensor
    brick_h: torch.Tensor
    brick_points: torch.Tensor  # i32[N, MAX_BRICKS]
    brick_depth: torch.Tensor
    brick_row: torch.Tensor
    brick_col: torch.Tensor
    brick_alive: torch.Tensor   # bool[N, MAX_BRICKS]
    brick_destructible: torch.Tensor
    brick_color: torch.Tensor   # int64[N, MAX_BRICKS] packed u32 RGBA
    brick_exists: torch.Tensor  # bool[N, MAX_BRICKS] capacity mask

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(State))

# State fields `step` never writes (only new_game / state_from_json touch
# them). The batched env's fast auto-reset skips the done-select on these.
STEP_CONSTANT_FIELDS = (
    "paddle_y", "paddle_width", "paddle_speed", "ball_radius",
    "brick_x", "brick_y", "brick_w", "brick_h", "brick_points",
    "brick_depth", "brick_row", "brick_col", "brick_destructible",
    "brick_color", "brick_exists")


def config_from_json(d: dict, device="cuda") -> Config:
    device = torch.device(device)
    starts = d["ball_start_positions"]
    # Transcendentals are computed on the host in f64 and rounded to f32,
    # as the JAX package does, so trajectories agree across backends.
    angles = np.asarray([s["angle_degrees"] for s in starts], np.float64)
    rad = angles * (np.pi / 180.0)
    ux = np.cos(rad).astype(np.float32)
    uy = (-np.sin(rad)).astype(np.float32)
    nseg = max(int(d["paddle_discrete_segments"]), 1)
    seg_angles = (150.0 - np.arange(nseg) * (120.0 / max(nseg - 1, 1))) \
        * (np.pi / 180.0)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return Config(
        device=device,
        ball_start_x=t([s["x"] for s in starts], F32),
        ball_start_y=t([s["y"] for s in starts], F32),
        ball_start_ux=t(ux, F32),
        ball_start_uy=t(uy, F32),
        seg_cos=t(np.cos(seg_angles).astype(np.float32), F32),
        seg_sin=t(np.sin(seg_angles).astype(np.float32), F32),
        start_lives=int(d["start_lives"]),
        row_scores=t(d["row_scores"], I32),
        row_colors=t([pack_color(jsonutil.color_from_json(c))
                      for c in d["row_colors"]], I64),
        ball_speed_row_depth=int(d["ball_speed_row_depth"]),
        ball_speed_slow=_f32(d["ball_speed_slow"]),
        ball_speed_fast=_f32(d["ball_speed_fast"]),
        bg_color=pack_color(jsonutil.color_from_json(d["bg_color"])),
        frame_color=pack_color(jsonutil.color_from_json(d["frame_color"])),
        paddle_color=pack_color(jsonutil.color_from_json(d["paddle_color"])),
        ball_color=pack_color(jsonutil.color_from_json(d["ball_color"])),
    )


def default_config(device="cuda") -> Config:
    return config_from_json(_DEFAULT_CONFIG_JSON, device)


def _serve_vector(config: Config, idx: torch.Tensor):
    """Ball start pos/vel [N] for start-position indices idx [N]."""
    idx = idx.long()
    speed = config.ball_speed_slow
    return (config.ball_start_x[idx], config.ball_start_y[idx],
            speed * config.ball_start_ux[idx],
            speed * config.ball_start_uy[idx])


def _default_bricks(config: Config, n: int) -> dict:
    """The default brick layout, one [MAX_BRICKS] row expanded to [n, ...]
    (views: no copy per env)."""
    dev = config.device
    rows = np.zeros(MAX_BRICKS, np.int64)
    cols = np.zeros(MAX_BRICKS, np.int64)
    rows[:DEFAULT_BRICKS] = np.arange(DEFAULT_BRICKS) % N_ROWS
    cols[:DEFAULT_BRICKS] = np.arange(DEFAULT_BRICKS) // N_ROWS
    exists = np.zeros(MAX_BRICKS, bool)
    exists[:DEFAULT_BRICKS] = True
    rows_t = torch.as_tensor(rows, device=dev)
    cols_t = torch.as_tensor(cols, device=dev)
    ex = torch.as_tensor(exists, device=dev)
    points = config.row_scores[rows_t]
    colors = config.row_colors[rows_t]
    depth = (N_ROWS - 1 - rows_t).to(I32)
    zero_i = torch.zeros((), dtype=I32, device=dev)
    one = dict(
        brick_x=12.0 + 12.0 * cols_t.to(F32),
        brick_y=43.0 + 4.0 * rows_t.to(F32),
        brick_w=torch.full((MAX_BRICKS,), 12.0, dtype=F32, device=dev),
        brick_h=torch.full((MAX_BRICKS,), 4.0, dtype=F32, device=dev),
        brick_points=torch.where(ex, points, zero_i),
        brick_depth=torch.where(ex, depth, zero_i),
        brick_row=rows_t.to(I32), brick_col=cols_t.to(I32),
        brick_alive=ex, brick_destructible=ex,
        brick_color=torch.where(ex, colors, torch.zeros_like(colors)),
        brick_exists=ex,
    )
    return {k: v.expand(n, MAX_BRICKS) for k, v in one.items()}


def _with_first(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x [N, B] with column 0 replaced by v [N]."""
    return torch.cat([v[:, None].to(x.dtype), x[:, 1:]], dim=1)


def _parked_ball_alive(n: int, device) -> torch.Tensor:
    alive = torch.zeros(MAX_BALLS, dtype=BOOL, device=device)
    alive[0] = True
    return alive.expand(n, MAX_BALLS)


def dynamic_fields(config: Config, keys: torch.Tensor) -> dict:
    """The fields of a fresh game that ``step`` writes, from engine rng
    states ``keys`` [N, 4] (before the serve draw)."""
    n = keys.shape[0]
    dev = config.device
    keys, start_idx = rng.randint(keys, 4)
    px, py, vx, vy = _serve_vector(config, start_idx)
    zb = torch.zeros((n, MAX_BALLS), dtype=F32, device=dev)
    zi = torch.zeros((n,), dtype=I32, device=dev)
    zf = torch.zeros((n,), dtype=F32, device=dev)
    true = torch.ones((n,), dtype=BOOL, device=dev)
    return dict(
        score=zi,
        lives=torch.full((n,), config.start_lives, dtype=I32, device=dev),
        level=torch.ones((n,), dtype=I32, device=dev),
        rng=keys, is_dead=true, reset=true,
        paddle_x=torch.full((n,), 120.0, dtype=F32, device=dev),
        paddle_vx=zf,
        ball_x=_with_first(zb, px), ball_y=_with_first(zb, py),
        ball_vx=_with_first(zb, vx), ball_vy=_with_first(zb, vy),
        ball_alive=_parked_ball_alive(n, dev),
        brick_alive=_default_bricks(config, n)["brick_alive"],
    )


def new_game(config: Config, seeds: torch.Tensor) -> State:
    """Fresh games, one per u32 seed in ``seeds`` [N].

    Constant fields are broadcast views shared by all envs: replace a
    field with a new tensor rather than writing into it."""
    dev = config.device
    keys = rng.seed(torch.as_tensor(seeds, device=dev))
    n = keys.shape[0]
    full = lambda v: torch.full((n,), v, dtype=F32, device=dev)  # noqa: E731
    bricks = _default_bricks(config, n)
    return State(
        **dynamic_fields(config, keys),
        paddle_y=full(PADDLE_Y), paddle_width=full(24.0),
        paddle_speed=full(4.0), ball_radius=full(2.0),
        **{k: v for k, v in bricks.items() if k != "brick_alive"},
    )


def _reflect_paddle(config: Config, s: State, bx, by, bvx, bvy):
    """Discrete-segment paddle reflection over [N, B] balls."""
    r = s.ball_radius[:, None]
    px, py = s.paddle_x[:, None], s.paddle_y[:, None]
    width = s.paddle_width[:, None]
    half = width * 0.5
    hit = ((bvy > 0)
           & (by + r >= py)
           & (by - r <= py + PADDLE_HEIGHT)
           & ((bx - px).abs() <= half + r))
    nseg = config.seg_cos.shape[0]
    frac = ((bx - (px - half)) / width.clamp_min(1e-6)).clamp(0.0, 0.999)
    seg = torch.floor(frac * float(nseg)).long()
    speed = torch.sqrt(bvx * bvx + bvy * bvy)
    return (torch.where(hit, speed * config.seg_cos[seg], bvx),
            torch.where(hit, -speed * config.seg_sin[seg], bvy))


def _ball_substep(config: Config, s: State, bricks_alive,
                  bx, by, bvx, bvy, balive):
    """Advance all balls [N, B] by vel/SUBSTEPS and resolve collisions with
    the walls, the paddle and the bricks ([N, B, M] intermediates)."""
    r = s.ball_radius[:, None]
    bx = bx + bvx / SUBSTEPS
    by = by + bvy / SUBSTEPS

    # walls
    bvx = torch.where(bx - r < LEFT_WALL, bvx.abs(),
                      torch.where(bx + r > RIGHT_WALL, -bvx.abs(), bvx))
    bvy = torch.where(by - r < TOP_WALL, bvy.abs(), bvy)
    bx = torch.clamp(bx, LEFT_WALL + r, RIGHT_WALL - r)
    by = torch.maximum(by, TOP_WALL + r)

    # paddle
    bvx, bvy = _reflect_paddle(config, s, bx, by, bvx, bvy)

    # bricks: AABB overlap, [N, B, M]
    cx = s.brick_x + s.brick_w * 0.5
    cy = s.brick_y + s.brick_h * 0.5
    dx = cx[:, None, :] - bx[:, :, None]
    dy = cy[:, None, :] - by[:, :, None]
    thx = s.brick_w * 0.5 + r
    thy = s.brick_h * 0.5 + r
    pen_x = thx[:, None, :] - dx.abs()
    pen_y = thy[:, None, :] - dy.abs()
    hit = ((pen_x > 0) & (pen_y > 0)
           & (bricks_alive & s.brick_exists)[:, None, :]
           & balive[:, :, None])

    flipx_mask = hit & (pen_x < pen_y)
    flipy_mask = hit & (pen_x >= pen_y)
    zero = torch.zeros((), dtype=F32, device=bx.device)
    sx = torch.where(flipx_mask, dx, zero).sum(-1)
    sy = torch.where(flipy_mask, dy, zero).sum(-1)
    bvx = torch.where(flipx_mask.any(-1),
                      torch.where(sx > 0, -bvx.abs(), bvx.abs()), bvx)
    bvy = torch.where(flipy_mask.any(-1),
                      torch.where(sy > 0, -bvy.abs(), bvy.abs()), bvy)

    destroyed = hit.any(1) & s.brick_destructible
    score_delta = torch.where(destroyed, s.brick_points,
                              torch.zeros((), dtype=I32, device=bx.device)
                              ).sum(-1, dtype=I32)
    bricks_alive = bricks_alive & ~destroyed
    speedup = (destroyed
               & (s.brick_depth >= config.ball_speed_row_depth)).any(-1)

    # bottom exit
    balive = balive & ~(by - r > BOTTOM)
    return bx, by, bvx, bvy, balive, score_delta, speedup, bricks_alive


def step(config: Config, s: State, inp: Input) -> State:
    """One engine frame for every env. inp: batched Input of bool [N]."""
    game_over = s.lives <= 0

    # paddle kinematics
    move = inp.right.to(F32) - inp.left.to(F32)
    vx = s.paddle_speed * move
    half = s.paddle_width * 0.5
    s = s.replace(paddle_x=torch.clamp(s.paddle_x + vx, LEFT_WALL + half,
                                       RIGHT_WALL - half),
                  paddle_vx=vx)

    # serve
    serving = s.reset & inp.button1 & ~game_over
    s = s.replace(reset=s.reset & ~serving, is_dead=s.is_dead & ~serving)

    # ball integration (masked while waiting to serve)
    active = ~s.reset & ~s.is_dead & ~game_over
    bx, by, bvx, bvy = s.ball_x, s.ball_y, s.ball_vx, s.ball_vy
    alive = s.ball_alive
    bricks = s.brick_alive
    score_delta = torch.zeros_like(s.score)
    speedup_any = torch.zeros_like(s.reset)
    for _ in range(SUBSTEPS):
        bx, by, bvx, bvy, alive, sd, sp, bricks = _ball_substep(
            config, s, bricks, bx, by, bvx, bvy, alive)
        score_delta = score_delta + sd
        speedup_any = speedup_any | sp

    # row-depth speedup: rescale all ball velocities to fast
    tgt = torch.full((), config.ball_speed_fast, dtype=F32, device=bx.device)
    mag = torch.sqrt(bvx * bvx + bvy * bvy)
    # a tensor numerator: python `float / tensor` multiplies by a reciprocal
    scale = torch.where(speedup_any[:, None] & (mag > 1e-6),
                        tgt / mag.clamp_min(1e-6),
                        torch.ones((), dtype=F32, device=bx.device))
    bvx = bvx * scale
    bvy = bvy * scale

    a = active[:, None]
    s = s.replace(
        ball_x=torch.where(a, bx, s.ball_x),
        ball_y=torch.where(a, by, s.ball_y),
        ball_vx=torch.where(a, bvx, s.ball_vx),
        ball_vy=torch.where(a, bvy, s.ball_vy),
        ball_alive=torch.where(a, alive, s.ball_alive),
        brick_alive=torch.where(a, bricks, s.brick_alive),
        score=torch.where(active, s.score + score_delta, s.score))

    parked = _parked_ball_alive(s.score.shape[0], bx.device)

    def serve_pose(s, mask, key, idx):
        spx, spy, svx, svy = _serve_vector(config, idx)
        m = mask[:, None]
        return dict(
            reset=s.reset | mask, is_dead=s.is_dead | mask,
            rng=torch.where(m, key, s.rng),
            ball_x=torch.where(m, _with_first(s.ball_x, spx), s.ball_x),
            ball_y=torch.where(m, _with_first(s.ball_y, spy), s.ball_y),
            ball_vx=torch.where(m, _with_first(s.ball_vx, svx), s.ball_vx),
            ball_vy=torch.where(m, _with_first(s.ball_vy, svy), s.ball_vy),
            ball_alive=torch.where(m, parked, s.ball_alive))

    # death: all balls gone
    died = active & ~s.ball_alive.any(-1)
    key, start_idx = rng.randint(s.rng, 4)
    s = s.replace(lives=torch.where(died, s.lives - 1, s.lives),
                  **serve_pose(s, died, key, start_idx))

    # level clear: respawn all bricks, back to serve pose
    cleared = active & ~(s.brick_alive & s.brick_destructible
                         & s.brick_exists).any(-1)
    key2, idx2 = rng.randint(s.rng, 4)
    s = s.replace(level=torch.where(cleared, s.level + 1, s.level),
                  brick_alive=torch.where(cleared[:, None], s.brick_exists,
                                          s.brick_alive),
                  **serve_pose(s, cleared, key2, idx2))
    return s


def score(s: State) -> torch.Tensor:
    return s.score


def lives(s: State) -> torch.Tensor:
    return s.lives


# ---------------------------------------------------------------------------
# Render (plain reference; the pipeline renders with ops/render_cuda.py)
# ---------------------------------------------------------------------------

def _brick_grid(s: State):
    """Packed u32 brick colors on a [N, MAX_RENDER_ROWS, N_COLS] grid and
    its occupancy (summed per cell, as the JAX one-hot product sums)."""
    n = s.score.shape[0]
    rows = s.brick_row.long().clamp(0, MAX_RENDER_ROWS - 1)
    cols = s.brick_col.long().clamp(0, N_COLS - 1)
    show = s.brick_alive & s.brick_exists
    idx = rows * N_COLS + cols
    rgb = torch.where(show, s.brick_color & 0xFFFFFF,
                      torch.zeros_like(s.brick_color))
    cells = MAX_RENDER_ROWS * N_COLS
    grid = torch.zeros((n, cells), dtype=I64, device=rgb.device)
    grid = grid.scatter_add(1, idx, rgb)
    occ = torch.zeros((n, cells), dtype=I64, device=rgb.device)
    occ = occ.scatter_add(1, idx, show.long())
    shape = (n, MAX_RENDER_ROWS, N_COLS)
    return (grid | 0xFF000000).view(shape), (occ > 0).view(shape)


def render(config: Config, s: State) -> torch.Tensor:
    """RGBA frames u8[N, HEIGHT, WIDTH, 4], composed in packed-u32 space."""
    n = s.score.shape[0]
    dev = s.score.device
    img = torch.full((n, HEIGHT, WIDTH), config.bg_color, dtype=I64,
                     device=dev)
    frame = (rect_mask(HEIGHT, WIDTH, 0, TOP_WALL, LEFT_WALL, HEIGHT, dev)
             | rect_mask(HEIGHT, WIDTH, RIGHT_WALL, TOP_WALL, WIDTH, HEIGHT,
                         dev)
             | rect_mask(HEIGHT, WIDTH, 0, TOP_WALL, WIDTH, TOP_WALL + 3,
                         dev))
    img = torch.where(frame, config.frame_color, img)

    grid, occ = _brick_grid(s)
    band_c = grid.repeat_interleave(BRICK_CELL_H, 1).repeat_interleave(
        BRICK_CELL_W, 2)
    band_o = occ.repeat_interleave(BRICK_CELL_H, 1).repeat_interleave(
        BRICK_CELL_W, 2)
    y0, x0 = BRICK_BAND_Y0, 12
    y1, x1 = y0 + BRICK_BAND_H, x0 + N_COLS * BRICK_CELL_W
    img[:, y0:y1, x0:x1] = torch.where(band_o, band_c, img[:, y0:y1, x0:x1])

    half = s.paddle_width * 0.5
    pm = rect_mask(HEIGHT, WIDTH, s.paddle_x - half, s.paddle_y,
                   s.paddle_x + half, s.paddle_y + PADDLE_HEIGHT, dev)
    img = torch.where(pm, config.paddle_color, img)

    r = s.ball_radius
    show = s.ball_alive & ~s.reset[:, None]
    for i in range(MAX_BALLS):
        bx, by = s.ball_x[:, i], s.ball_y[:, i]
        m = (rect_mask(HEIGHT, WIDTH, bx - r, by - r, bx + r, by + r, dev)
             & show[:, i, None, None])
        img = torch.where(m, config.ball_color, img)
    return unpack_color(img)


# ---------------------------------------------------------------------------
# JSON codec (reference live-schema keys), one env at a time
# ---------------------------------------------------------------------------

def _color_json_packed(p) -> dict:
    p = int(p)
    return jsonutil.color_to_json([(p >> sh) & 0xFF for sh in (0, 8, 16, 24)])


def state_to_json(config: Config, s: State, i: int = 0) -> dict:
    """The reference JSON state of env ``i``."""
    h = {f: getattr(s, f)[i].cpu() for f in FIELDS}
    f64 = {f: h[f].double().numpy() for f in (
        "ball_x", "ball_y", "ball_vx", "ball_vy",
        "brick_x", "brick_y", "brick_w", "brick_h")}
    alive = h["ball_alive"].numpy()
    balls = [{"position": {"x": float(f64["ball_x"][b]),
                           "y": float(f64["ball_y"][b])},
              "velocity": {"x": float(f64["ball_vx"][b]),
                           "y": float(f64["ball_vy"][b])}}
             for b in range(MAX_BALLS) if alive[b]]
    ex = h["brick_exists"].numpy()
    bricks = []
    for b in range(MAX_BRICKS):
        if not ex[b]:
            continue
        bricks.append({
            "destructible": bool(h["brick_destructible"][b]),
            "depth": int(h["brick_depth"][b]),
            "color": _color_json_packed(h["brick_color"][b]),
            "alive": bool(h["brick_alive"][b]),
            "points": int(h["brick_points"][b]),
            "size": {"x": float(f64["brick_w"][b]),
                     "y": float(f64["brick_h"][b])},
            "position": {"x": float(f64["brick_x"][b]),
                         "y": float(f64["brick_y"][b])},
            "row": int(h["brick_row"][b]),
            "col": int(h["brick_col"][b]),
        })
    return {
        "score": int(h["score"]),
        "lives": int(h["lives"]),
        "level": int(h["level"]),
        "rand": {"state": rng.to_u64_pair(h["rng"].numpy())},
        "is_dead": bool(h["is_dead"]),
        "reset": bool(h["reset"]),
        "paddle": {
            "position": {"x": float(h["paddle_x"].double()),
                         "y": float(h["paddle_y"].double())},
            "velocity": {"x": float(h["paddle_vx"].double()), "y": 0.0},
        },
        "paddle_width": float(h["paddle_width"].double()),
        "paddle_speed": float(h["paddle_speed"].double()),
        "ball_radius": float(h["ball_radius"].double()),
        "balls": balls,
        "bricks": bricks,
    }

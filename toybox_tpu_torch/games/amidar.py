"""Amidar engine in PyTorch (port of toybox_tpu.games.amidar).

The state is a struct of tensors with a leading env axis: ``score[N]``,
``tiles[N, 992]`` (the 31 x 32 board, flat), ``enemy_x[N, 8]`` and so on,
the same fields as the JAX ``State``. ``step`` advances every env by one
engine frame with the same integer arithmetic, in the same order, as the
JAX step, so seeded trajectories and their state-JSON digests are
identical.

dtypes: i32 fields stay int32, ``tiles`` int8, bools bool; the ``rng``
words are held in int64, masked to 32 bits (see ``core/rng.py``).

Where the JAX package shaped a lookup for the TPU, the port gathers:
walkability is one ``walk4[tile]`` gather (the JAX step tests bits of u32
row masks), and the LookupAI route cursor reads ``routes_flat[ridx * 128
+ next]`` (the JAX step factors it through a bf16 one-hot matmul, exact by
construction). Box completion stays a 0/1 product in f32: every sum is an
integer below 2**24, so it is exact at any matmul precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toybox_tpu_torch.core import jsonutil, rng
from toybox_tpu_torch.core.actions import LEGAL_ACTIONS as _LEGAL
from toybox_tpu_torch.core.types import Input
from toybox_tpu_torch.games.common import F32, pack_color, unpack_color

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool

GAME_NAME = "amidar"
WIDTH = 160
HEIGHT = 250
LEGAL_ACTIONS = _LEGAL["amidar"]

BOARD_W = 32
BOARD_H = 31
N_TILES = BOARD_W * BOARD_H
WORLD_TX = 64            # world units per tile, x
WORLD_TY = 80            # world units per tile, y
WORLD_PER_PIXEL = 16
TILE_PX_W = WORLD_TX // WORLD_PER_PIXEL   # 4
TILE_PX_H = WORLD_TY // WORLD_PER_PIXEL   # 5
BOARD_PX_X = 16          # board origin on screen (pixels)
BOARD_PX_Y = 45
BOARD_PX_H = BOARD_H * TILE_PX_H     # 155
BOARD_PX_W = BOARD_W * TILE_PX_W     # 128

MAX_ENEMIES = 8
MAX_BOXES = 32
MAX_JUNCTIONS = 64
MAX_ROUTE = 128
MAX_HISTORY = 8

# Tile codes
EMPTY, UNPAINTED, PAINTED, CHASE_MARKER = 0, 1, 2, 3
TILE_TAGS = ["Empty", "Unpainted", "Painted", "ChaseMarker"]

# Direction codes + STOP; reverse = d ^ 1.
UP, DOWN, LEFT, RIGHT, STOP = 0, 1, 2, 3, 4
DIR_NAMES = ["Up", "Down", "Left", "Right"]
_RIGHT_OF = (RIGHT, LEFT, UP, DOWN)   # indexed by UP, DOWN, LEFT, RIGHT
_DIRV = np.array([[0, -1], [0, 1], [-1, 0], [1, 0], [0, 0]], np.int32)
_REVERSE = np.array([1, 0, 3, 2, 4], np.int32)

# Enemy AI protocol codes
P_LOOKUP, P_PERIMETER, P_AMIDAR, P_RANDOM, P_TARGET = 0, 1, 2, 3, 4
PROTOCOL_NAMES = ["EnemyLookupAI", "EnemyPerimeterAI", "EnemyAmidarMvmt",
                  "EnemyRandomMvmt", "EnemyTargetPlayer"]
PROTOCOL_CODE = {n: i for i, n in enumerate(PROTOCOL_NAMES)}

# Default spawn tiles for the 5 default LookupAI routes.
DEFAULT_ROUTE_SPAWNS = [(0, 0), (0, 0), (7, 0), (0, 25), (9, 30)]

_DEFAULT_BOARD = [
    "c========================c======",
    "=     =   =   =  =   =   =     =",
    "=     =   =   =  =   =   =     =",
    "=     =   =   =  =   =   =     =",
    "=     =   =   =  =   =   =     =",
    "=     =   =   =  =   =   =     =",
    "================================",
    "=   =    =  =      =  =    =   =",
    "=   =    =  =      =  =    =   =",
    "=   =    =  =      =  =    =   =",
    "=   =    =  =      =  =    =   =",
    "=   =    =  =      =  =    =   =",
    "================================",
    "=  =       =        =       =  p",
    "=  =       =        =       =  p",
    "=  =       =        =       =  p",
    "=  =       =        =       =  p",
    "=  =       =        =       =  p",
    "===============================p",
    "=    =        =  =        =    =",
    "=    =        =  =        =    =",
    "=    =        =  =        =    =",
    "=    =        =  =        =    =",
    "=    =        =  =        =    =",
    "c========================c======",
    "=     =     =      =     =     =",
    "=     =     =      =     =     =",
    "=     =     =      =     =     =",
    "=     =     =      =     =     =",
    "=     =     =      =     =     =",
    "================================",
]

_DEFAULT_CONFIG_JSON = {
    "board": _DEFAULT_BOARD,
    "enemies": [{"EnemyLookupAI": {"default_route_index": i, "next": 0}}
                for i in range(5)],
    "jump_time": 75,
    "chase_time": 300,
    "box_bonus": 50,
    "chase_score_bonus": 100,
    "start_lives": 3,
    "start_jumps": 4,
    "default_board_bugs": True,
    "render_images": True,
    "player_start": {"tx": 31, "ty": 15},
    "bg_color": {"r": 0, "g": 0, "b": 0, "a": 255},
    "player_color": {"r": 255, "g": 255, "b": 153, "a": 255},
    "enemy_color": {"r": 255, "g": 50, "b": 100, "a": 255},
    "unpainted_color": {"r": 148, "g": 0, "b": 211, "a": 255},
    "painted_color": {"r": 255, "g": 255, "b": 30, "a": 255},
    "inner_painted_color": {"r": 255, "g": 255, "b": 0, "a": 255},
    "rand": {"state": [1817879012901901412, 10917585336602961851]},
}


# ---------------------------------------------------------------------------
# Host-side board analysis (numpy; runs once per config)
# ---------------------------------------------------------------------------

def _parse_board(board_strs):
    """char map -> tile code grid i8[BOARD_H, BOARD_W]: '=' track
    (Unpainted), ' ' Empty, 'c' ChaseMarker, 'p' Painted."""
    h = len(board_strs)
    w = len(board_strs[0])
    grid = np.zeros((h, w), np.int8)
    for y, row in enumerate(board_strs):
        for x, ch in enumerate(row):
            grid[y, x] = {"=": UNPAINTED, " ": EMPTY,
                          "c": CHASE_MARKER, "p": PAINTED}[ch]
    return grid


def _walkable_np(grid):
    return grid != EMPTY


def _walk4_np(grid):
    """[N_TILES, 4] bool: can an entity at tile t head in direction d."""
    walk = _walkable_np(grid)
    out = np.zeros((BOARD_H, BOARD_W, 4), bool)
    out[1:, :, UP] = walk[:-1, :]
    out[:-1, :, DOWN] = walk[1:, :]
    out[:, 1:, LEFT] = walk[:, :-1]
    out[:, :-1, RIGHT] = walk[:, 1:]
    out &= walk[:, :, None]
    return out.reshape(N_TILES, 4)


def _find_junctions(grid):
    """Track tiles with a track neighbor on both a vertical and a horizontal
    side. Junction id = ty * BOARD_W + tx."""
    h, w = grid.shape
    walk = _walkable_np(grid)
    ids = []
    for y in range(h):
        for x in range(w):
            if not walk[y, x]:
                continue
            vert = ((y > 0 and walk[y - 1, x])
                    or (y + 1 < h and walk[y + 1, x]))
            horiz = ((x > 0 and walk[y, x - 1])
                     or (x + 1 < w and walk[y, x + 1]))
            if vert and horiz:
                ids.append(y * w + x)
    return ids


def _find_boxes(grid):
    """Boxes = cells of the lattice: consecutive full-track rows x
    consecutive verticals spanning the band."""
    h, w = grid.shape
    walk = _walkable_np(grid)
    full_rows = [y for y in range(h) if walk[y].all()]
    boxes = []
    for y1, y2 in zip(full_rows[:-1], full_rows[1:]):
        verts = [x for x in range(w) if walk[y1:y2 + 1, x].all()]
        for x1, x2 in zip(verts[:-1], verts[1:]):
            boxes.append((x1, y1, x2, y2))
    return boxes


def _box_perimeter_masks(grid, boxes):
    masks = np.zeros((MAX_BOXES, BOARD_H, BOARD_W), bool)
    for i, (x1, y1, x2, y2) in enumerate(boxes[:MAX_BOXES]):
        masks[i, y1, x1:x2 + 1] = True
        masks[i, y2, x1:x2 + 1] = True
        masks[i, y1:y2 + 1, x1] = True
        masks[i, y1:y2 + 1, x2] = True
    return masks


def _wall_follow_route(grid, start, max_len=MAX_ROUTE):
    """Cycle of junction ids from wall-following (prefer straight, then
    right-turn, then left-turn, never reverse unless dead end): the
    LookupAI route table."""
    h, w = grid.shape
    walk = _walkable_np(grid)
    junctions = set(_find_junctions(grid))

    def ok(x, y):
        return 0 <= x < w and 0 <= y < h and walk[y, x]

    x, y = start
    d = None
    for cand in (RIGHT, DOWN, LEFT, UP):
        dx, dy = _DIRV[cand]
        if ok(x + dx, y + dy):
            d = cand
            break
    if d is None:
        return [y * w + x]

    right_of = {UP: RIGHT, RIGHT: DOWN, DOWN: LEFT, LEFT: UP}
    left_of = {v: k for k, v in right_of.items()}

    route = []
    seen = {}
    sx, sy = x, y
    for _ in range(4 * w * h):
        dx, dy = _DIRV[d]
        x, y = x + dx, y + dy
        tid = y * w + x
        if tid in junctions:
            key = (x, y, d)
            if key in seen:
                route = route[seen[key]:]
                break
            seen[key] = len(route)
            route.append(tid)
        for cand in (d, right_of[d], left_of[d], _REVERSE[d]):
            cdx, cdy = _DIRV[cand]
            if ok(x + cdx, y + cdy):
                d = cand
                break
    if not route:
        route = [sy * w + sx]
    return route[:max_len]


# ---------------------------------------------------------------------------
# Config / State
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Config:
    """Game constants: python numbers, host tables (numpy) for the JSON
    codec, and device tables for the step."""
    device: torch.device
    base_tiles: torch.Tensor       # i8[N_TILES] initial tile codes
    walk4: torch.Tensor            # bool[N_TILES, 4] move-from-tile-in-dir
    is_junction: torch.Tensor      # bool[N_TILES]
    box_triggers: torch.Tensor     # bool[MAX_BOXES]
    box_exists: torch.Tensor       # bool[MAX_BOXES]
    box_masks: torch.Tensor        # f32[N_TILES, MAX_BOXES] perimeters
    box_sizes: torch.Tensor        # f32[MAX_BOXES] perimeter tile counts
    inner_masks: torch.Tensor      # f32[MAX_BOXES, N_TILES] interiors
    routes_flat: torch.Tensor      # i32[MAX_ENEMIES * MAX_ROUTE] tile ids
    route_len: torch.Tensor        # i32[MAX_ENEMIES]
    enemy_exists: torch.Tensor     # bool[MAX_ENEMIES]
    enemy_protocol: torch.Tensor   # i32[MAX_ENEMIES]
    enemy_route_index: torch.Tensor  # i32[MAX_ENEMIES]
    enemy_spawn_tx: torch.Tensor   # i32[MAX_ENEMIES]
    enemy_spawn_ty: torch.Tensor   # i32[MAX_ENEMIES]
    right_of: torch.Tensor         # i32[4] the right turn of each direction
    enemy_salt: torch.Tensor       # int64[MAX_ENEMIES] u32 0x9E3779B9 * e
    box_tl: np.ndarray             # i32[MAX_BOXES, 2] (tx, ty)
    box_br: np.ndarray             # i32[MAX_BOXES, 2]
    junction_ids: tuple            # junction tile ids
    chase_junctions: tuple         # up to 4 tile ids
    player_start: tuple            # (tx, ty)
    jump_time: int
    chase_time: int
    box_bonus: int
    chase_score_bonus: int
    start_lives: int
    start_jumps: int
    bg_color: int                  # packed u32 RGBA
    player_color: int
    enemy_color: int
    unpainted_color: int
    painted_color: int
    inner_painted_color: int


@dataclasses.dataclass(frozen=True)
class State:
    score: torch.Tensor             # i32[N]
    lives: torch.Tensor             # i32[N]
    level: torch.Tensor             # i32[N]
    jumps: torch.Tensor             # i32[N]
    jump_timer: torch.Tensor        # i32[N]
    chase_timer: torch.Tensor       # i32[N]
    rng: torch.Tensor               # int64[N, 4] u32 words
    tiles: torch.Tensor             # i8[N, N_TILES]
    box_painted: torch.Tensor       # bool[N, MAX_BOXES]
    player_x: torch.Tensor          # i32[N] world
    player_y: torch.Tensor          # i32[N]
    player_dir: torch.Tensor        # i32[N] (STOP = 4)
    player_speed: torch.Tensor      # i32[N]
    player_caught: torch.Tensor     # bool[N]
    player_history: torch.Tensor    # i32[N, MAX_HISTORY] junction ids (ring)
    player_history_len: torch.Tensor  # i32[N] (total count)
    player_step: torch.Tensor       # i32[N] (-1 = null)
    enemy_exists: torch.Tensor      # bool[N, E]
    enemy_x: torch.Tensor           # i32[N, E] world
    enemy_y: torch.Tensor           # i32[N, E]
    enemy_dir: torch.Tensor         # i32[N, E]
    enemy_speed: torch.Tensor       # i32[N, E]
    enemy_caught: torch.Tensor      # bool[N, E]
    enemy_protocol: torch.Tensor    # i32[N, E]
    enemy_next: torch.Tensor        # i32[N, E] LookupAI route cursor
    enemy_route_index: torch.Tensor  # i32[N, E]
    enemy_route_len: torch.Tensor   # i32[N, E]
    enemy_target: torch.Tensor      # i32[N, E] current route target
    enemy_start_tx: torch.Tensor    # i32[N, E] tile
    enemy_start_ty: torch.Tensor    # i32[N, E]
    enemy_vert: torch.Tensor        # i32[N, E] Direction code
    enemy_horiz: torch.Tensor       # i32[N, E]
    enemy_start_vert: torch.Tensor  # i32[N, E]
    enemy_start_horiz: torch.Tensor  # i32[N, E]
    enemy_start_dir: torch.Tensor   # i32[N, E]
    enemy_dir_field: torch.Tensor   # i32[N, E] the AI 'dir' field
    enemy_vision: torch.Tensor      # i32[N, E] vision_distance
    enemy_seen_tx: torch.Tensor     # i32[N, E]; -1 = None
    enemy_seen_ty: torch.Tensor     # i32[N, E]

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(State))


def config_from_json(d: dict, device="cuda") -> Config:
    device = torch.device(device)
    grid = _parse_board(d["board"])
    junctions = _find_junctions(grid)
    boxes = _find_boxes(grid)[:MAX_BOXES]
    chase = [tid for tid in junctions
             if grid[tid // BOARD_W, tid % BOARD_W] == CHASE_MARKER]
    is_j = np.zeros(N_TILES, bool)
    is_j[junctions] = True

    btl = np.zeros((MAX_BOXES, 2), np.int32)
    bbr = np.zeros((MAX_BOXES, 2), np.int32)
    btrig = np.zeros(MAX_BOXES, bool)
    bex = np.zeros(MAX_BOXES, bool)
    inner = np.zeros((MAX_BOXES, BOARD_H, BOARD_W), np.float32)
    chase_set = set(chase)
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        btl[i] = (x1, y1)
        bbr[i] = (x2, y2)
        btrig[i] = (y1 * BOARD_W + x1) in chase_set
        bex[i] = True
        inner[i, y1 + 1:y2, x1 + 1:x2] = 1.0
    masks = _box_perimeter_masks(grid, boxes).reshape(MAX_BOXES, N_TILES)

    e_exists = np.zeros(MAX_ENEMIES, bool)
    e_proto = np.zeros(MAX_ENEMIES, np.int32)
    e_ridx = np.zeros(MAX_ENEMIES, np.int32)
    e_stx = np.zeros(MAX_ENEMIES, np.int32)
    e_sty = np.zeros(MAX_ENEMIES, np.int32)
    routes = np.zeros((MAX_ENEMIES, MAX_ROUTE), np.int32)
    route_len = np.ones(MAX_ENEMIES, np.int32)
    for i, e in enumerate(d["enemies"][:MAX_ENEMIES]):
        name = list(e.keys())[0]
        args = e[name]
        e_exists[i] = True
        e_proto[i] = PROTOCOL_CODE[name]
        if name == "EnemyLookupAI":
            ridx = int(args.get("default_route_index", i))
            e_ridx[i] = ridx
            spawn = DEFAULT_ROUTE_SPAWNS[ridx % len(DEFAULT_ROUTE_SPAWNS)]
        elif "start" in args and args["start"] is not None:
            spawn = (int(args["start"]["tx"]), int(args["start"]["ty"]))
        else:
            spawn = DEFAULT_ROUTE_SPAWNS[i % len(DEFAULT_ROUTE_SPAWNS)]
        e_stx[i], e_sty[i] = spawn
        r = _wall_follow_route(grid, spawn)
        routes[i, :len(r)] = r
        route_len[i] = len(r)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def color(key):
        return pack_color(jsonutil.color_from_json(d[key]))

    return Config(
        device=device,
        base_tiles=t(grid.reshape(-1)),
        walk4=t(_walk4_np(grid)),
        is_junction=t(is_j),
        box_triggers=t(btrig), box_exists=t(bex),
        box_masks=t(masks.T, F32),
        box_sizes=t(masks.sum(axis=1), F32),
        inner_masks=t(inner.reshape(MAX_BOXES, N_TILES)),
        routes_flat=t(routes.reshape(-1)),
        route_len=t(route_len),
        enemy_exists=t(e_exists), enemy_protocol=t(e_proto),
        enemy_route_index=t(e_ridx),
        enemy_spawn_tx=t(e_stx), enemy_spawn_ty=t(e_sty),
        right_of=t(_RIGHT_OF, I32),
        enemy_salt=t([(0x9E3779B9 * i) & rng.MASK32
                      for i in range(MAX_ENEMIES)], I64),
        box_tl=btl, box_br=bbr,
        junction_ids=tuple(junctions[:MAX_JUNCTIONS]),
        chase_junctions=tuple(sorted(chase)[:4]),
        player_start=(int(d["player_start"]["tx"]),
                      int(d["player_start"]["ty"])),
        jump_time=int(d["jump_time"]),
        chase_time=int(d["chase_time"]),
        box_bonus=int(d["box_bonus"]),
        chase_score_bonus=int(d["chase_score_bonus"]),
        start_lives=int(d["start_lives"]),
        start_jumps=int(d["start_jumps"]),
        bg_color=color("bg_color"),
        player_color=color("player_color"),
        enemy_color=color("enemy_color"),
        unpainted_color=color("unpainted_color"),
        painted_color=color("painted_color"),
        inner_painted_color=color("inner_painted_color"),
    )


def default_config(device="cuda") -> Config:
    return config_from_json(_DEFAULT_CONFIG_JSON, device)


# ---------------------------------------------------------------------------
# Coordinate and direction helpers (integer tensors; `//` and `%` floor,
# as jnp's do)
# ---------------------------------------------------------------------------

def _tx_of(x):
    return (x + WORLD_TX // 2) // WORLD_TX


def _ty_of(y):
    return (y + WORLD_TY // 2) // WORLD_TY


def _can4(config: Config, tx, ty):
    """can4 [..., 4] (UP, DOWN, LEFT, RIGHT): moving from tile (tx, ty) in
    direction d is legal iff both the tile and its d-neighbour are track;
    all False off the board."""
    on = (tx >= 0) & (tx < BOARD_W) & (ty >= 0) & (ty < BOARD_H)
    flat = (ty.clamp(0, BOARD_H - 1) * BOARD_W + tx.clamp(0, BOARD_W - 1))
    return config.walk4[flat.long()] & on[..., None]


def _pick4(table4, d):
    """table4[..., d] for d in 0..3; False for any other d (STOP)."""
    got = table4.gather(-1, d.clamp(0, 3).long()[..., None])[..., 0]
    return got & (d >= 0) & (d <= 3)


def _rev(d):
    return torch.where(d == STOP, STOP, d ^ 1)


def _dx_of(d):
    return (d == RIGHT).to(I32) - (d == LEFT).to(I32)


def _dy_of(d):
    return (d == DOWN).to(I32) - (d == UP).to(I32)


def _first_true(conds, values, default):
    """values[k] for the first k with conds[k] True, else default (int32)."""
    out = torch.full_like(conds[0], default, dtype=I32)
    for c, v in zip(reversed(conds), reversed(values)):
        out = torch.where(c, v, out)
    return out


# ---------------------------------------------------------------------------
# New game
# ---------------------------------------------------------------------------

def new_game(config: Config, seeds: torch.Tensor) -> State:
    """Fresh games, one per u32 seed in ``seeds`` [N].

    Constant fields are broadcast views shared by all envs: replace a
    field with a new tensor rather than writing into it."""
    dev = config.device
    keys = rng.seed(torch.as_tensor(seeds, device=dev))
    n = keys.shape[0]
    e = MAX_ENEMIES

    def full(v, dtype=I32, shape=()):
        return torch.full((n,) + shape, v, dtype=dtype, device=dev)

    def per_env(t):
        return t.expand((n,) + tuple(t.shape))

    ptx, pty = config.player_start
    hist = torch.full((MAX_HISTORY,), -1, dtype=I32, device=dev)
    hist[0] = pty * BOARD_W + ptx
    ridx = config.enemy_route_index.clamp(0, MAX_ENEMIES - 1).long()
    return State(
        score=full(0), lives=full(config.start_lives), level=full(0),
        jumps=full(config.start_jumps), jump_timer=full(0),
        chase_timer=full(0),
        rng=keys,
        tiles=per_env(config.base_tiles),
        box_painted=full(False, BOOL, (MAX_BOXES,)),
        player_x=full(ptx * WORLD_TX), player_y=full(pty * WORLD_TY),
        player_dir=full(STOP), player_speed=full(8),
        player_caught=full(False, BOOL),
        player_history=per_env(hist), player_history_len=full(1),
        player_step=full(-1),
        enemy_exists=per_env(config.enemy_exists),
        enemy_x=per_env(config.enemy_spawn_tx * WORLD_TX),
        enemy_y=per_env(config.enemy_spawn_ty * WORLD_TY),
        enemy_dir=full(RIGHT, I32, (e,)),
        enemy_speed=full(8, I32, (e,)),
        enemy_caught=full(False, BOOL, (e,)),
        enemy_protocol=per_env(config.enemy_protocol),
        enemy_next=full(0, I32, (e,)),
        enemy_route_index=per_env(config.enemy_route_index),
        enemy_route_len=per_env(config.route_len[ridx].clamp_min(1)),
        enemy_target=per_env(config.routes_flat[ridx * MAX_ROUTE]),
        enemy_start_tx=per_env(config.enemy_spawn_tx),
        enemy_start_ty=per_env(config.enemy_spawn_ty),
        enemy_vert=full(DOWN, I32, (e,)),
        enemy_horiz=full(RIGHT, I32, (e,)),
        enemy_start_vert=full(DOWN, I32, (e,)),
        enemy_start_horiz=full(RIGHT, I32, (e,)),
        enemy_start_dir=full(RIGHT, I32, (e,)),
        enemy_dir_field=full(RIGHT, I32, (e,)),
        enemy_vision=full(15, I32, (e,)),
        enemy_seen_tx=full(-1, I32, (e,)),
        enemy_seen_ty=full(-1, I32, (e,)),
    )


# ---------------------------------------------------------------------------
# Enemy AI: every protocol computed for every enemy, then selected
# ---------------------------------------------------------------------------

def _step_enemies(config: Config, s: State, bits) -> State:
    """Advance all enemies [N, E] one frame. bits: u32 (int64) [N, E]."""
    dev = bits.device
    ex_, ey = s.enemy_x, s.enemy_y
    d = s.enemy_dir
    tx, ty = _tx_of(ex_), _ty_of(ey)
    flat = ty * BOARD_W + tx
    at_c = (ex_ % WORLD_TX == 0) & (ey % WORLD_TY == 0)
    can4 = _can4(config, tx, ty)                      # [N, E, 4]

    d0 = d.clamp(0, 3)
    rev_d = _rev(d0)

    # -- LookupAI: follow the precomputed junction route ------------------
    reached = flat == s.enemy_target
    nxt = torch.where(reached, (s.enemy_next + 1) % s.enemy_route_len,
                      s.enemy_next)
    key = s.enemy_route_index.clamp(0, MAX_ENEMIES - 1) * MAX_ROUTE + nxt
    in_table = (key >= 0) & (key < MAX_ENEMIES * MAX_ROUTE)
    target_new = torch.where(
        in_table, config.routes_flat[key.clamp(0, MAX_ENEMIES * MAX_ROUTE - 1)
                                     .long()], 0)
    target = torch.where(reached, target_new, s.enemy_target)
    dxt = target % BOARD_W - tx
    dyt = target // BOARD_W - ty
    d_look = _first_true([dxt > 0, dxt < 0, dyt > 0, dyt < 0],
                         [RIGHT, LEFT, DOWN, UP], STOP)
    d_look = torch.where(d_look == STOP, d0, d_look)
    d_look = torch.where(_pick4(can4, d_look), d_look, rev_d)

    # -- PerimeterAI: wall-follow straight > right > left > reverse -------
    r_of = config.right_of[d0.long()]
    order = [d0, r_of, r_of ^ 1, rev_d]      # straight, right, left, back
    d_perim = _first_true([_pick4(can4, o) for o in order], order, STOP)

    # -- AmidarMvmt: zigzag sweep -----------------------------------------
    vert, horiz = s.enemy_vert, s.enemy_horiz
    can_v = _pick4(can4, vert)
    can_h = _pick4(can4, horiz)
    can_rh = _pick4(can4, _rev(horiz))
    moving_v = (d == UP) | (d == DOWN)
    d_zig = torch.where(can_v, vert, torch.where(
        can_h, horiz, torch.where(can_rh, _rev(horiz), _rev(vert))))
    new_vert = torch.where(moving_v & ~can_v, _rev(vert), vert)
    new_horiz = torch.where(~can_v & ~can_h, _rev(horiz), horiz)

    # -- RandomMvmt: uniform over walkable non-reverse dirs ---------------
    dirs4 = torch.arange(4, dtype=I32, device=dev)
    ok_fwd = can4 & (dirs4 != rev_d[..., None])
    use = torch.where(ok_fwd.any(-1, keepdim=True), ok_fwd, can4)
    n = use.sum(-1).clamp_min(1)
    pick = bits % n                                    # u32 modulo
    sel = ((use.to(I32).cumsum(-1) - 1) == pick[..., None]) & use
    # argmax returns the first index of the maximum, as jnp.argmax does
    d_rand = torch.where(use.any(-1), sel.to(I32).argmax(-1).to(I32), STOP)

    # -- TargetPlayer: chase within vision, else random -------------------
    ptx = _tx_of(s.player_x)[:, None]
    pty = _ty_of(s.player_y)[:, None]
    sees = (ptx - tx).abs() + (pty - ty).abs() <= s.enemy_vision
    seen_tx = torch.where(sees, ptx, s.enemy_seen_tx)
    seen_ty = torch.where(sees, pty, s.enemy_seen_ty)
    reached_seen = (seen_tx == tx) & (seen_ty == ty) & (seen_tx >= 0)
    seen_tx = torch.where(reached_seen, -1, seen_tx)
    seen_ty = torch.where(reached_seen, -1, seen_ty)
    has_target = seen_tx >= 0
    dxp = seen_tx - tx
    dyp = seen_ty - ty
    pref_x = _first_true([dxp > 0, dxp < 0], [RIGHT, LEFT], STOP)
    pref_y = _first_true([dyp > 0, dyp < 0], [DOWN, UP], STOP)
    xfirst = dxp.abs() >= dyp.abs()
    first = torch.where(xfirst, pref_x, pref_y)
    second = torch.where(xfirst, pref_y, pref_x)
    d_greedy = _first_true([_pick4(can4, first), _pick4(can4, second)],
                           [first, second], STOP)
    d_tgt = torch.where(has_target & (d_greedy != STOP), d_greedy, d_rand)

    # -- combine by protocol ----------------------------------------------
    p = s.enemy_protocol
    d_new = torch.where(p == P_LOOKUP, d_look, torch.where(
        p == P_PERIMETER, d_perim, torch.where(
            p == P_AMIDAR, d_zig, torch.where(p == P_RANDOM, d_rand, d_tgt))))
    lookup_upd = (p == P_LOOKUP) & at_c
    nxt = torch.where(lookup_upd, nxt, s.enemy_next)
    target = torch.where(lookup_upd, target, s.enemy_target)
    amidar_upd = (p == P_AMIDAR) & at_c
    new_vert = torch.where(amidar_upd, new_vert, s.enemy_vert)
    new_horiz = torch.where(amidar_upd, new_horiz, s.enemy_horiz)
    dirf = torch.where(((p == P_RANDOM) | (p == P_TARGET)) & at_c, d_new,
                       s.enemy_dir_field)
    target_upd = (p == P_TARGET) & at_c
    seen_tx = torch.where(target_upd, seen_tx, s.enemy_seen_tx)
    seen_ty = torch.where(target_upd, seen_ty, s.enemy_seen_ty)

    nd = torch.where(at_c, d_new, d)
    # a blocked enemy reverses rather than stalls
    blocked = at_c & ~_pick4(can4, nd)
    nd = torch.where(blocked, _rev(nd.clamp(0, 3)), nd)
    nd = torch.where(at_c & ~_pick4(can4, nd), STOP, nd)

    alive = s.enemy_exists
    nd = torch.where(alive, nd, s.enemy_dir)
    return s.replace(
        enemy_x=torch.where(alive, ex_ + _dx_of(nd) * 8, ex_),
        enemy_y=torch.where(alive, ey + _dy_of(nd) * 8, ey),
        enemy_dir=nd,
        enemy_next=torch.where(alive, nxt, s.enemy_next),
        enemy_target=torch.where(alive, target, s.enemy_target),
        enemy_vert=torch.where(alive, new_vert, s.enemy_vert),
        enemy_horiz=torch.where(alive, new_horiz, s.enemy_horiz),
        enemy_dir_field=torch.where(alive, dirf, s.enemy_dir_field),
        enemy_seen_tx=torch.where(alive, seen_tx, s.enemy_seen_tx),
        enemy_seen_ty=torch.where(alive, seen_ty, s.enemy_seen_ty),
    )


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def step(config: Config, s: State, inp: Input) -> State:
    """One engine frame for every env. inp: batched Input of bool [N]."""
    dev = s.score.device
    game_over = s.lives <= 0

    # --- timers -----------------------------------------------------------
    s = s.replace(jump_timer=(s.jump_timer - 1).clamp_min(0),
                  chase_timer=(s.chase_timer - 1).clamp_min(0))
    s = s.replace(enemy_caught=s.enemy_caught & (s.chase_timer != 0)[:, None])

    # --- jump consumption (FIRE) -----------------------------------------
    do_jump = inp.button1 & (s.jumps > 0) & (s.jump_timer == 0) & ~game_over
    s = s.replace(
        jumps=s.jumps - do_jump.to(I32),
        jump_timer=torch.where(do_jump, config.jump_time, s.jump_timer))

    # --- player movement --------------------------------------------------
    want = _first_true([inp.up, inp.down, inp.left, inp.right],
                       [UP, DOWN, LEFT, RIGHT], STOP)
    px, py = s.player_x, s.player_y
    at_c = (px % WORLD_TX == 0) & (py % WORLD_TY == 0)
    pcan4 = _can4(config, _tx_of(px), _ty_of(py))     # [N, 4]
    cur = s.player_dir
    rev_ok = ~at_c & (want == _rev(cur)) & (cur != STOP)
    mid_dir = torch.where(rev_ok, want, cur)
    center_dir = torch.where(_pick4(pcan4, want), want, STOP)
    new_dir = torch.where(at_c, center_dir, mid_dir)
    new_dir = torch.where(game_over, STOP, new_dir)
    npx = px + _dx_of(new_dir) * s.player_speed
    npy = py + _dy_of(new_dir) * s.player_speed

    # --- painting ---------------------------------------------------------
    nflat = _ty_of(npy) * BOARD_W + _tx_of(npx)
    landed = (npx % WORLD_TX == 0) & (npy % WORLD_TY == 0) & ~game_over
    on_board = (nflat >= 0) & (nflat < N_TILES)
    nidx = nflat.clamp(0, N_TILES - 1).long()
    t_code = torch.where(on_board, s.tiles.gather(1, nidx[:, None])[:, 0], 0)
    paints = landed & ((t_code == UNPAINTED) | (t_code == CHASE_MARKER))
    onehot_n = torch.arange(N_TILES, device=dev) == nflat[:, None]
    tiles = torch.where(paints[:, None] & onehot_n, PAINTED, s.tiles)
    score = s.score + paints.to(I32)

    # history: record junction visits (a ring of MAX_HISTORY)
    is_j = landed & on_board & config.is_junction[nidx]
    hlen = s.player_history_len
    hi = torch.arange(MAX_HISTORY, dtype=I32, device=dev)
    last = torch.where(hi == ((hlen - 1) % MAX_HISTORY)[:, None],
                       s.player_history, 0).sum(-1, dtype=I32)
    push = is_j & (nflat != last)
    hist = torch.where(push[:, None] & (hi == (hlen % MAX_HISTORY)[:, None]),
                       nflat[:, None], s.player_history)
    hlen = hlen + push.to(I32)

    # --- box completion: a 0/1 product, exact in f32 ----------------------
    counts = (tiles == PAINTED).to(F32) @ config.box_masks   # [N, MAX_BOXES]
    box_done = (counts >= config.box_sizes) & config.box_exists
    newly = box_done & ~s.box_painted
    score = score + newly.sum(-1, dtype=I32) * config.box_bonus
    start_chase = (newly & config.box_triggers).any(-1)
    s = s.replace(
        player_x=npx, player_y=npy, player_dir=new_dir, tiles=tiles,
        score=score, player_history=hist, player_history_len=hlen,
        box_painted=box_done,
        chase_timer=torch.where(start_chase, config.chase_time,
                                s.chase_timer))

    # --- enemies ----------------------------------------------------------
    key, frame_bits = rng.next_u32(s.rng)
    ebits = rng._mix32((frame_bits[:, None] + config.enemy_salt)
                       & rng.MASK32)
    s = _step_enemies(config, s.replace(rng=key), ebits)

    # --- collisions -------------------------------------------------------
    touching = (((s.enemy_x - s.player_x[:, None]).abs() < WORLD_TX // 2)
                & ((s.enemy_y - s.player_y[:, None]).abs() < WORLD_TY // 2)
                & s.enemy_exists)
    jumping = (s.jump_timer > 0)[:, None]
    chasing = (s.chase_timer > 0)[:, None]

    # chase mode: catch enemies -> bonus + respawn at their start corner
    catchable = touching & chasing & ~s.enemy_caught & ~game_over[:, None]
    spawn_x = s.enemy_start_tx * WORLD_TX
    spawn_y = s.enemy_start_ty * WORLD_TY
    s = s.replace(
        score=(s.score
               + catchable.sum(-1, dtype=I32) * config.chase_score_bonus),
        enemy_x=torch.where(catchable, spawn_x, s.enemy_x),
        enemy_y=torch.where(catchable, spawn_y, s.enemy_y),
        enemy_caught=s.enemy_caught | catchable)

    # regular mode: the player dies
    killed = ((touching & ~jumping & ~chasing & ~s.enemy_caught).any(-1)
              & ~game_over)
    k = killed[:, None]
    ptx, pty = config.player_start
    s = s.replace(
        lives=s.lives - killed.to(I32),
        player_x=torch.where(killed, ptx * WORLD_TX, s.player_x),
        player_y=torch.where(killed, pty * WORLD_TY, s.player_y),
        player_dir=torch.where(killed, STOP, s.player_dir),
        enemy_x=torch.where(k, spawn_x, s.enemy_x),
        enemy_y=torch.where(k, spawn_y, s.enemy_y),
        jump_timer=torch.where(killed, 0, s.jump_timer),
        chase_timer=torch.where(killed, 0, s.chase_timer))

    # --- level completion: all boxes painted ------------------------------
    done = (s.box_painted | ~config.box_exists).all(-1) & ~game_over
    dn = done[:, None]
    return s.replace(
        level=s.level + done.to(I32),
        tiles=torch.where(dn, config.base_tiles, s.tiles),
        box_painted=s.box_painted & ~dn,
        jumps=s.jumps + done.to(I32),
        player_x=torch.where(done, ptx * WORLD_TX, s.player_x),
        player_y=torch.where(done, pty * WORLD_TY, s.player_y),
        enemy_x=torch.where(dn, spawn_x, s.enemy_x),
        enemy_y=torch.where(dn, spawn_y, s.enemy_y),
        player_dir=torch.where(done, STOP, s.player_dir),
    )


def score(s: State) -> torch.Tensor:
    return s.score


def lives(s: State) -> torch.Tensor:
    return s.lives


# ---------------------------------------------------------------------------
# Render (plain reference; the pipeline renders with ops/render_amidar.py)
# ---------------------------------------------------------------------------

def inner_painted(config: Config, s: State) -> torch.Tensor:
    """bool[N, N_TILES]: tiles inside a painted box (a 0/1 product, exact
    in f32)."""
    return (s.box_painted.to(F32) @ config.inner_masks) > 0.5


def render(config: Config, s: State) -> torch.Tensor:
    """RGBA frames u8[N, HEIGHT, WIDTH, 4]: 4x5 px tiles at (BOARD_PX_X,
    BOARD_PX_Y), then the enemies and the player as 4x5 rects."""
    n = s.score.shape[0]
    dev = s.score.device
    t = s.tiles
    cell = torch.where(
        t == EMPTY,
        torch.where(inner_painted(config, s), config.inner_painted_color,
                    config.bg_color),
        torch.where(t == PAINTED, config.painted_color,
                    config.unpainted_color))            # int64 [N, N_TILES]
    board = cell.view(n, BOARD_H, BOARD_W).repeat_interleave(
        TILE_PX_H, 1).repeat_interleave(TILE_PX_W, 2)
    img = torch.full((n, HEIGHT, WIDTH), config.bg_color, dtype=I64,
                     device=dev)
    img[:, BOARD_PX_Y:BOARD_PX_Y + BOARD_PX_H,
        BOARD_PX_X:BOARD_PX_X + BOARD_PX_W] = board

    ys = torch.arange(HEIGHT, dtype=I32, device=dev)[:, None]
    xs = torch.arange(WIDTH, dtype=I32, device=dev)[None, :]

    def sprite(img, wx, wy, packed, ok):
        sx = (BOARD_PX_X + wx // WORLD_PER_PIXEL)[:, None, None]
        sy = (BOARD_PX_Y + wy // WORLD_PER_PIXEL)[:, None, None]
        m = ((xs >= sx) & (xs < sx + TILE_PX_W) & (ys >= sy)
             & (ys < sy + TILE_PX_H) & ok[:, None, None])
        return torch.where(m, packed, img)

    for i in range(MAX_ENEMIES):
        img = sprite(img, s.enemy_x[:, i], s.enemy_y[:, i],
                     config.enemy_color, s.enemy_exists[:, i])
    img = sprite(img, s.player_x, s.player_y, config.player_color,
                 torch.ones(n, dtype=BOOL, device=dev))
    return unpack_color(img)


# ---------------------------------------------------------------------------
# JSON codec (reference live-schema keys), one env at a time
# ---------------------------------------------------------------------------

def _ai_to_json(h: dict, i: int) -> dict:
    name = PROTOCOL_NAMES[int(h["enemy_protocol"][i])]

    def tp(x, y):
        return {"tx": int(x), "ty": int(y)}

    def dname(key):
        return DIR_NAMES[int(np.clip(h[key][i], 0, 3))]

    start = tp(h["enemy_start_tx"][i], h["enemy_start_ty"][i])
    if name == "EnemyLookupAI":
        return {name: {"next": int(h["enemy_next"][i]),
                       "default_route_index": int(h["enemy_route_index"][i])}}
    if name == "EnemyPerimeterAI":
        return {name: {"start": start}}
    if name == "EnemyAmidarMvmt":
        return {name: {
            "vert": DIR_NAMES[int(h["enemy_vert"][i])],
            "horiz": DIR_NAMES[int(h["enemy_horiz"][i])],
            "start_vert": DIR_NAMES[int(h["enemy_start_vert"][i])],
            "start_horiz": DIR_NAMES[int(h["enemy_start_horiz"][i])],
            "start": start}}
    if name == "EnemyRandomMvmt":
        return {name: {
            "start": start,
            "start_dir": DIR_NAMES[int(h["enemy_start_dir"][i])],
            "dir": dname("enemy_dir_field")}}
    stx = int(h["enemy_seen_tx"][i])
    return {name: {
        "start": start,
        "start_dir": DIR_NAMES[int(h["enemy_start_dir"][i])],
        "vision_distance": int(h["enemy_vision"][i]),
        "dir": dname("enemy_dir_field"),
        "player_seen": (None if stx < 0
                        else tp(stx, h["enemy_seen_ty"][i]))}}


def state_to_json(config: Config, s: State, i: int = 0) -> dict:
    """The reference JSON state of env ``i``."""
    h = {f: getattr(s, f)[i].cpu().numpy() for f in FIELDS}
    tiles = h["tiles"].reshape(BOARD_H, BOARD_W)
    ex = config.box_exists.cpu().numpy()
    trig = config.box_triggers.cpu().numpy()
    boxes = [{
        "triggers_chase": bool(trig[b]),
        "top_left": {"tx": int(config.box_tl[b, 0]),
                     "ty": int(config.box_tl[b, 1])},
        "bottom_right": {"tx": int(config.box_br[b, 0]),
                         "ty": int(config.box_br[b, 1])},
        "painted": bool(h["box_painted"][b]),
    } for b in range(MAX_BOXES) if ex[b]]
    hist_len = int(h["player_history_len"])
    n = min(hist_len, MAX_HISTORY)
    start = (hist_len - n) % MAX_HISTORY
    history = [int(h["player_history"][(start + k) % MAX_HISTORY])
               for k in range(n)]

    def step_of(d):
        # the movement direction rides in the reference's `step`
        return None if int(d) == STOP else int(d)

    def entity(x, y, caught, speed, d, history, ai):
        return {"history": history, "step": step_of(d),
                "position": {"x": int(x), "y": int(y)},
                "caught": bool(caught), "speed": int(speed), "ai": ai}

    enemies = [entity(h["enemy_x"][e], h["enemy_y"][e], h["enemy_caught"][e],
                      h["enemy_speed"][e], h["enemy_dir"][e], [],
                      _ai_to_json(h, e))
               for e in range(MAX_ENEMIES) if h["enemy_exists"][e]]
    return {
        "score": int(h["score"]),
        "lives": int(h["lives"]),
        "level": int(h["level"]),
        "jumps": int(h["jumps"]),
        "jump_timer": int(h["jump_timer"]),
        "chase_timer": int(h["chase_timer"]),
        "rand": {"state": rng.to_u64_pair(h["rng"])},
        "player": entity(h["player_x"], h["player_y"], h["player_caught"],
                         h["player_speed"], h["player_dir"], history,
                         "Player"),
        "enemies": enemies,
        "board": {
            "width": BOARD_W,
            "height": BOARD_H,
            "tiles": [[TILE_TAGS[int(c)] for c in row] for row in tiles],
            "boxes": boxes,
            "junctions": list(config.junction_ids),
            "chase_junctions": list(config.chase_junctions),
        },
    }

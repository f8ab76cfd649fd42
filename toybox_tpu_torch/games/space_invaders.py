"""Space Invaders engine in PyTorch (port of toybox_tpu.games.space_invaders).

The state is a struct of tensors with a leading env axis: ``score[N]``,
``enemy_x[N, 36]``, ``shield_alpha[N, S, 18, 16]`` and so on, the same
fields as the JAX ``State``. ``step`` advances every env by one engine
frame with the same integer arithmetic, in the same order, as the JAX
step, so seeded trajectories and their state-JSON digests are identical.

dtypes: i32 fields stay int32, bools bool; the ``rng`` words are held in
int64, masked to 32 bits (see ``core/rng.py``). The shields are bool
pixel masks; the JAX package packs their rows into u32 bit masks, which
changes nothing that is observable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toybox_tpu_torch.core import rng
from toybox_tpu_torch.core.actions import LEGAL_ACTIONS as _LEGAL
from toybox_tpu_torch.core.types import Input
from toybox_tpu_torch.games.common import pack_color, unpack_color

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool

GAME_NAME = "space_invaders"
WIDTH = 320
HEIGHT = 210
LEGAL_ACTIONS = _LEGAL["space_invaders"]

N_ROWS = 6
N_COLS = 6
N_ENEMIES = N_ROWS * N_COLS
ENEMY_X0, ENEMY_Y0 = 44, 31          # formation top-left at game start
ENEMY_DX, ENEMY_DY = 32, 18          # grid spacing
ENEMY_W, ENEMY_H = 16, 10            # collision box
SHIP_Y = 185
SHIP_W, SHIP_H = 16, 10
SHIELD_W, SHIELD_H = 16, 18
MAX_ENEMY_LASERS = 4

SHIP_LASER_SPEED = 6
ENEMY_LASER_SPEED = 3
LASER_W, LASER_H = 2, 8

MARCH_STEP_X = 2                      # formation shift per march tick
MARCH_STEP_Y = 8                      # drop on direction reversal
MARCH_LEFT_LIMIT = 8
MARCH_RIGHT_LIMIT = WIDTH - 8
ENEMY_FLOOR = SHIP_Y - ENEMY_H        # enemies reaching here end the game

UFO_POINTS = 100
UFO_SPEED = 2
UFO_Y = 12
UFO_RESET = 500
DEATH_ANIM = 16                       # death animation frames
SHIP_DEATH_ANIM = 60

LEFT_D, RIGHT_D, UP_D, DOWN_D = 2, 3, 0, 1  # Direction codes

# Shield alpha mask (18 rows x 16 cols, [y][x]), as in the JAX package.
_SHIELD_MASK_STRS = [
    "0000111111110000",
    "0000111111110000",
    "0011111111111100",
    "0011111111111100",
    "0011111111111100",
    "0011111111111100",
    "0011111111111100",
    "0011111111111100",
    "0011111111111100",
    "0011111111111100",
    "1111111111111111",
    "1111111111111111",
    "1111111111111111",
    "1111111111111111",
    "1111111111111111",
    "1111111111111111",
    "1111000000001111",
    "1111000000001111",
]
SHIELD_MASK = np.array([[c == "1" for c in row] for row in _SHIELD_MASK_STRS])

SHIELD_COLOR = pack_color([172, 80, 48, 255])
SHIP_COLOR = pack_color([35, 129, 59, 255])
ENEMY_COLOR = pack_color([200, 200, 200, 255])
LASER_COLOR = pack_color([255, 255, 255, 255])
UFO_COLOR = pack_color([151, 25, 122, 255])
BG_COLOR = pack_color([0, 0, 0, 255])

_DEFAULT_CONFIG_JSON = {
    "jitter": 0.5,
    "shields": [[84, 157], [148, 157], [212, 157]],
    "row_scores": [30, 30, 20, 20, 10, 10],
    "enemy_protocol": "TargetPlayer",
    "start_lives": 3,
    "rand": {"state": [14138799424576617778, 15827758918122478082]},
}

ENEMY_PROTOCOLS = ["TargetPlayer", "Random"]


@dataclasses.dataclass(frozen=True)
class Config:
    """Game constants: python numbers, and small tables on ``device``."""
    device: torch.device
    jitter: float                # the JSON's jitter rounded to f32, as the
                                 # step compares it (JAX's weak typing)
    shield_pos: tuple            # ((x, y), ...)
    shield_xy: torch.Tensor      # i32[S, 2]
    shield_mask: torch.Tensor    # bool[SHIELD_H, SHIELD_W] intact shield
    row_scores: torch.Tensor     # i32[N_ROWS]
    enemy_points: torch.Tensor   # i32[N_ENEMIES] row_scores by enemy row
    enemy_protocol: int          # 0 TargetPlayer, 1 Random
    start_lives: int


@dataclasses.dataclass(frozen=True)
class State:
    score: torch.Tensor                # i32[N]
    lives: torch.Tensor                # i32[N]
    level: torch.Tensor                # i32[N]
    rng: torch.Tensor                  # int64[N, 4] u32 words
    life_display_timer: torch.Tensor   # i32[N]
    enemy_shot_delay: torch.Tensor     # i32[N]
    shot_timer: torch.Tensor           # i32[N]
    ship_x: torch.Tensor               # i32[N]
    ship_y: torch.Tensor               # i32[N]
    ship_alive: torch.Tensor           # bool[N]
    ship_death_counter: torch.Tensor   # i32[N] (-1 = null)
    ship_death_hit_1: torch.Tensor     # bool[N]
    ship_laser_alive: torch.Tensor     # bool[N]
    ship_laser_x: torch.Tensor         # i32[N]
    ship_laser_y: torch.Tensor         # i32[N]
    ship_laser_t: torch.Tensor         # i32[N]
    elaser_alive: torch.Tensor         # bool[N, L]
    elaser_x: torch.Tensor             # i32[N, L]
    elaser_y: torch.Tensor             # i32[N, L]
    elaser_t: torch.Tensor             # i32[N, L]
    enemy_x: torch.Tensor              # i32[N, 36] (id = row * 6 + col)
    enemy_y: torch.Tensor              # i32[N, 36]
    enemy_alive: torch.Tensor          # bool[N, 36]
    enemy_death_counter: torch.Tensor  # i32[N, 36] (-1 = null)
    move_counter: torch.Tensor         # i32[N]
    move_dir: torch.Tensor             # i32[N] Direction code
    visual_orientation: torch.Tensor   # bool[N]
    shield_alpha: torch.Tensor         # bool[N, S, SHIELD_H, SHIELD_W]
    ufo_x: torch.Tensor                # i32[N]
    ufo_y: torch.Tensor                # i32[N]
    ufo_appearance_counter: torch.Tensor  # i32[N] (-1 = banished)
    ufo_death_counter: torch.Tensor       # i32[N] (-1 = null)

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(State))


def config_from_json(d: dict, device="cuda") -> Config:
    device = torch.device(device)
    shields = tuple(tuple(int(v) for v in xy) for xy in d["shields"])
    row_scores = torch.as_tensor(d["row_scores"], dtype=I32, device=device)
    rows = torch.arange(N_ENEMIES, device=device) // N_COLS
    return Config(
        device=device,
        jitter=float(np.float32(d["jitter"])),
        shield_pos=shields,
        shield_xy=torch.as_tensor(np.asarray(shields, np.int32).reshape(-1, 2),
                                  device=device),
        shield_mask=torch.as_tensor(SHIELD_MASK, device=device),
        row_scores=row_scores,
        enemy_points=row_scores[rows],
        enemy_protocol=ENEMY_PROTOCOLS.index(
            d.get("enemy_protocol", "TargetPlayer")),
        start_lives=int(d["start_lives"]),
    )


def default_config(device="cuda") -> Config:
    return config_from_json(_DEFAULT_CONFIG_JSON, device)


def _formation_xy(n: int, device):
    """Formation start positions, i32[n, 36] each (broadcast views)."""
    ids = torch.arange(N_ENEMIES, dtype=I32, device=device)
    x = ENEMY_X0 + (ids % N_COLS) * ENEMY_DX
    y = ENEMY_Y0 + (ids // N_COLS) * ENEMY_DY
    return x.expand(n, N_ENEMIES), y.expand(n, N_ENEMIES)


def _shield_start(config: Config, n: int) -> torch.Tensor:
    return config.shield_mask.expand(n, len(config.shield_pos), SHIELD_H,
                                     SHIELD_W)


def new_game(config: Config, seeds: torch.Tensor) -> State:
    """Fresh games, one per u32 seed in ``seeds`` [N].

    Constant fields are broadcast views shared by all envs: replace a
    field with a new tensor rather than writing into it."""
    dev = config.device
    keys = rng.seed(torch.as_tensor(seeds, device=dev))
    n = keys.shape[0]

    def full(v, dtype=I32, shape=()):
        return torch.full((n,) + shape, v, dtype=dtype, device=dev)

    ex, ey = _formation_xy(n, dev)
    lasers = (MAX_ENEMY_LASERS,)
    return State(
        score=full(0), lives=full(config.start_lives), level=full(0),
        rng=keys,
        life_display_timer=full(128), enemy_shot_delay=full(50),
        shot_timer=full(50),
        ship_x=full(68), ship_y=full(SHIP_Y),
        ship_alive=full(False, BOOL), ship_death_counter=full(-1),
        ship_death_hit_1=full(True, BOOL),
        ship_laser_alive=full(False, BOOL), ship_laser_x=full(0),
        ship_laser_y=full(0), ship_laser_t=full(0),
        elaser_alive=full(False, BOOL, lasers), elaser_x=full(0, I32, lasers),
        elaser_y=full(0, I32, lasers), elaser_t=full(0, I32, lasers),
        enemy_x=ex, enemy_y=ey,
        enemy_alive=full(True, BOOL, (N_ENEMIES,)),
        enemy_death_counter=full(-1, I32, (N_ENEMIES,)),
        move_counter=full(32), move_dir=full(RIGHT_D),
        visual_orientation=full(True, BOOL),
        shield_alpha=_shield_start(config, n),
        ufo_x=full(-2), ufo_y=full(UFO_Y),
        ufo_appearance_counter=full(UFO_RESET),
        ufo_death_counter=full(-1),
    )


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def _overlap(ax, ay, aw, ah, bx, by, bw, bh):
    return ((ax < bx + bw) & (ax + aw > bx)
            & (ay < by + bh) & (ay + ah > by))


def _shields_vs_lasers(config: Config, alpha, lx, ly, from_above, active):
    """Test L laser tips against all shields at once; erode blast patches.

    alpha bool[N, S, H, W]; lx/ly/active [N, L] (tip x at the laser's
    center, y at its leading edge); from_above bool[L]. Returns
    (new_alpha, hit bool[N, L])."""
    n, n_sh = alpha.shape[:2]
    px = lx[:, :, None] - config.shield_xy[:, 0]           # [N, L, S]
    py = ly[:, :, None] - config.shield_xy[:, 1]
    inside = (px >= 0) & (px < SHIELD_W) & (py >= 0) & (py < SHIELD_H)
    cell = (torch.arange(n_sh, device=px.device) * (SHIELD_H * SHIELD_W)
            + py.clamp(0, SHIELD_H - 1) * SHIELD_W
            + px.clamp(0, SHIELD_W - 1))
    solid = alpha.reshape(n, -1).gather(1, cell.reshape(n, -1).long()
                                        ).view(cell.shape)
    hit = inside & solid & active[:, :, None]              # [N, L, S]

    # blast: clear a 4-wide x 6-tall patch at the impact, biased in the
    # laser's travel direction
    y0 = torch.where(from_above[:, None], py, py - 5)
    hs = torch.arange(SHIELD_H, device=px.device)
    ws = torch.arange(SHIELD_W, device=px.device)
    rows_in = (hs >= y0[..., None]) & (hs < (y0 + 6)[..., None])
    cols_in = (ws >= (px - 1)[..., None]) & (ws <= (px + 2)[..., None])
    blast = (rows_in[..., :, None] & cols_in[..., None, :]
             & hit[..., None, None]).any(1)                # [N, S, H, W]
    return alpha & ~blast, hit.any(2)


def step(config: Config, s: State, inp: Input) -> State:
    """One engine frame for every env. inp: batched Input of bool [N]."""
    dev = s.score.device
    game_over = s.lives <= 0

    # --- intro / respawn pause: life display timer -----------------------
    paused = s.life_display_timer > 0
    s = s.replace(life_display_timer=(s.life_display_timer - 1).clamp_min(0))
    became_ready = paused & (s.life_display_timer == 0)
    s = s.replace(ship_alive=s.ship_alive | (became_ready & ~game_over))
    run = ~paused & ~game_over
    run_i = run.to(I32)

    # --- ship movement ----------------------------------------------------
    move = (inp.right.to(I32) - inp.left.to(I32)) * 3
    ship_x = (s.ship_x + torch.where(run & s.ship_alive, move, 0)).clamp(
        0, WIDTH - SHIP_W)
    s = s.replace(ship_x=ship_x)

    # --- ship death animation --------------------------------------------
    dying = s.ship_death_counter >= 0
    sdc = torch.where(dying, s.ship_death_counter - 1, -1)
    respawn = dying & (sdc < 0)
    s = s.replace(ship_death_counter=sdc,
                  ship_alive=s.ship_alive | (respawn & ~game_over),
                  ship_x=torch.where(respawn, 68, ship_x))

    # --- fire ship laser --------------------------------------------------
    can_fire = run & s.ship_alive & inp.button1 & ~s.ship_laser_alive
    s = s.replace(
        ship_laser_alive=s.ship_laser_alive | can_fire,
        ship_laser_x=torch.where(can_fire, s.ship_x + SHIP_W // 2,
                                 s.ship_laser_x),
        ship_laser_y=torch.where(can_fire, s.ship_y - LASER_H,
                                 s.ship_laser_y),
        ship_laser_t=torch.where(can_fire, 0, s.ship_laser_t))

    # --- move lasers ------------------------------------------------------
    sly = s.ship_laser_y - SHIP_LASER_SPEED * (run & s.ship_laser_alive
                                               ).to(I32)
    ely = s.elaser_y + ENEMY_LASER_SPEED * (run[:, None] & s.elaser_alive
                                            ).to(I32)
    s = s.replace(
        ship_laser_y=sly,
        ship_laser_alive=s.ship_laser_alive & (sly + LASER_H > 0),
        ship_laser_t=s.ship_laser_t + 1,
        elaser_y=ely, elaser_alive=s.elaser_alive & (ely < HEIGHT),
        elaser_t=s.elaser_t + 1)

    # --- enemy march ------------------------------------------------------
    n_alive = s.enemy_alive.sum(-1, dtype=I32)
    mc = s.move_counter - run_i
    tick = run & (mc <= 0)
    going_right = s.move_dir == RIGHT_D
    dx = (MARCH_STEP_X * (2 * going_right.to(I32) - 1))[:, None]
    ex = s.enemy_x
    at_edge = (s.enemy_alive & torch.where(
        going_right[:, None], ex + dx + ENEMY_W > MARCH_RIGHT_LIMIT,
        ex + dx < MARCH_LEFT_LIMIT)).any(-1)
    reverse = tick & at_edge
    shift_x = dx * (tick & ~reverse).to(I32)[:, None]
    shift_y = MARCH_STEP_Y * reverse.to(I32)[:, None]
    new_dir = torch.where(reverse, RIGHT_D - going_right.to(I32), s.move_dir)
    # cadence speeds up as the formation thins
    period = (2 + n_alive).clamp_min(4)
    s = s.replace(
        enemy_x=s.enemy_x + shift_x,
        enemy_y=s.enemy_y + shift_y,
        move_dir=new_dir,
        move_counter=torch.where(tick, period, mc),
        visual_orientation=s.visual_orientation ^ tick)

    # enemy death animations
    edc = s.enemy_death_counter
    s = s.replace(enemy_death_counter=torch.where(edc >= 0, edc - 1, -1))

    # --- enemy fire -------------------------------------------------------
    st = s.shot_timer - run_i
    do_shoot = run & (st <= 0) & (n_alive > 0)
    key, u = rng.uniform(s.rng)
    key, rcol = rng.randint(key, N_COLS)
    # TargetPlayer: aim at the ship's column with prob (1 - jitter)
    ids = torch.arange(N_ENEMIES, dtype=I32, device=dev)
    col_of = ids % N_COLS
    ship_cx = (s.ship_x + SHIP_W // 2)[:, None]
    coldist = (s.enemy_x + ENEMY_W // 2 - ship_cx).abs()
    # argmin returns the first index of the minimum, as jnp.argmin does
    target_col = col_of[torch.where(s.enemy_alive, coldist, 9999).argmin(-1)]
    random_mode = (config.enemy_protocol == 1) | (u < config.jitter)
    chosen_col = torch.where(random_mode, rcol, target_col)
    # bottom-most alive enemy in the chosen column (fall back to any column)
    in_col = (col_of == chosen_col[:, None]) & s.enemy_alive
    in_col = torch.where(in_col.any(-1, keepdim=True), in_col, s.enemy_alive)
    shooter_y = torch.where(in_col, s.enemy_y, -1).amax(-1)
    is_shooter = in_col & (s.enemy_y == shooter_y[:, None])
    # ties broken by lowest id (argmax picks the first True)
    first = is_shooter.to(I32).argmax(-1)
    is_shooter = is_shooter & (ids == first[:, None])
    shooter_x = torch.where(is_shooter, s.enemy_x, 0).sum(-1, dtype=I32)
    # spawn in the first free laser slot
    free = ~s.elaser_alive
    slot = free.to(I32).argmax(-1)
    can = do_shoot & free.any(-1)
    spawn = can[:, None] & (torch.arange(MAX_ENEMY_LASERS, device=dev)
                            == slot[:, None])
    s = s.replace(
        rng=key,
        shot_timer=torch.where(do_shoot, s.enemy_shot_delay, st),
        elaser_alive=s.elaser_alive | spawn,
        elaser_x=torch.where(spawn, (shooter_x + ENEMY_W // 2)[:, None],
                             s.elaser_x),
        elaser_y=torch.where(spawn, (shooter_y + ENEMY_H)[:, None],
                             s.elaser_y),
        elaser_t=torch.where(spawn, 0, s.elaser_t))

    # --- ufo --------------------------------------------------------------
    uac = s.ufo_appearance_counter
    flying = (uac == 0) & run
    uac = torch.where(run & (uac > 0), uac - 1, uac)
    ufo_x = torch.where(flying, s.ufo_x + UFO_SPEED, s.ufo_x)
    done_fly = flying & (ufo_x > WIDTH)
    udc = s.ufo_death_counter
    s = s.replace(ufo_x=torch.where(done_fly, -2, ufo_x),
                  ufo_appearance_counter=torch.where(done_fly, UFO_RESET, uac),
                  ufo_death_counter=torch.where(udc >= 0, udc - 1, -1))

    # --- ship laser collisions -------------------------------------------
    lx, ly = s.ship_laser_x, s.ship_laser_y
    sl = s.ship_laser_alive

    # vs enemies (the laser is 2 px wide and enemies 32 px apart, so at
    # most one is hit)
    ehit = (sl[:, None] & s.enemy_alive
            & _overlap(lx[:, None], ly[:, None], LASER_W, LASER_H,
                       s.enemy_x, s.enemy_y, ENEMY_W, ENEMY_H))
    points = torch.where(ehit, config.enemy_points, 0).sum(-1, dtype=I32)
    s = s.replace(
        enemy_alive=s.enemy_alive & ~ehit,
        enemy_death_counter=torch.where(ehit, DEATH_ANIM,
                                        s.enemy_death_counter),
        score=s.score + points,
        ship_laser_alive=sl & ~ehit.any(-1))

    # vs ufo
    sl = s.ship_laser_alive
    uhit = (sl & flying & ~done_fly
            & _overlap(lx, ly, LASER_W, LASER_H, s.ufo_x, s.ufo_y,
                       ENEMY_W, ENEMY_H))
    s = s.replace(
        score=s.score + UFO_POINTS * uhit.to(I32),
        ufo_death_counter=torch.where(uhit, DEATH_ANIM, s.ufo_death_counter),
        ufo_x=torch.where(uhit, -2, s.ufo_x),
        ufo_appearance_counter=torch.where(uhit, UFO_RESET,
                                           s.ufo_appearance_counter),
        ship_laser_alive=sl & ~uhit)

    # vs shields: the ship laser and the enemy lasers in one pass
    sl = s.ship_laser_alive
    elx, ely = s.elaser_x, s.elaser_y
    all_lx = torch.cat([(lx + LASER_W // 2)[:, None], elx + LASER_W // 2], 1)
    all_ly = torch.cat([ly[:, None], ely + LASER_H], 1)
    above = torch.ones(1 + MAX_ENEMY_LASERS, dtype=BOOL, device=dev)
    above[0] = False
    all_active = torch.cat([sl[:, None], s.elaser_alive], 1)
    alpha, hits = _shields_vs_lasers(config, s.shield_alpha, all_lx, all_ly,
                                     above, all_active)
    s = s.replace(shield_alpha=alpha,
                  ship_laser_alive=sl & ~hits[:, 0],
                  elaser_alive=s.elaser_alive & ~hits[:, 1:])

    # vs ship
    on_ship = _overlap(elx, ely, LASER_W, LASER_H, s.ship_x[:, None],
                       s.ship_y[:, None], SHIP_W, SHIP_H)      # [N, L]
    ship_hit = (s.elaser_alive & (s.ship_alive & run)[:, None]
                & on_ship).any(-1)
    s = s.replace(
        lives=s.lives - ship_hit.to(I32),
        ship_alive=s.ship_alive & ~ship_hit,
        ship_death_counter=torch.where(ship_hit, SHIP_DEATH_ANIM,
                                       s.ship_death_counter),
        ship_death_hit_1=s.ship_death_hit_1 | ship_hit,
        elaser_alive=s.elaser_alive & ~(ship_hit[:, None] & on_ship))

    # --- enemies reaching the ship row ends the game ----------------------
    landed = (s.enemy_alive & (s.enemy_y + ENEMY_H >= ENEMY_FLOOR)).any(-1)
    s = s.replace(lives=torch.where(landed & run, 0, s.lives))

    # --- level clear ------------------------------------------------------
    cleared = run & ~s.enemy_alive.any(-1)
    c = cleared[:, None]
    fx, fy = _formation_xy(s.score.shape[0], dev)
    return s.replace(
        level=s.level + cleared.to(I32),
        enemy_alive=s.enemy_alive | c,
        enemy_x=torch.where(c, fx, s.enemy_x),
        enemy_y=torch.where(c, fy, s.enemy_y),
        move_dir=torch.where(cleared, RIGHT_D, s.move_dir),
        move_counter=torch.where(cleared, 32, s.move_counter),
        shield_alpha=torch.where(c[:, :, None, None],
                                 _shield_start(config, s.score.shape[0]),
                                 s.shield_alpha),
        elaser_alive=s.elaser_alive & ~c,
        ship_laser_alive=s.ship_laser_alive & ~cleared,
        life_display_timer=torch.where(cleared, 128, s.life_display_timer),
        ship_alive=s.ship_alive & ~cleared,
    )


def score(s: State) -> torch.Tensor:
    return s.score


def lives(s: State) -> torch.Tensor:
    return s.lives


# ---------------------------------------------------------------------------
# Render (plain reference; the pipeline renders with ops/render_si.py)
# ---------------------------------------------------------------------------

def render(config: Config, s: State) -> torch.Tensor:
    """RGBA frames u8[N, HEIGHT, WIDTH, 4], composed in packed-u32 space in
    the JAX render's draw order: enemies, shields, ufo, ship, lasers."""
    n = s.score.shape[0]
    dev = s.score.device
    ys = torch.arange(HEIGHT, dtype=I32, device=dev)[:, None]
    xs = torch.arange(WIDTH, dtype=I32, device=dev)[None, :]
    img = torch.full((n, HEIGHT, WIDTH), BG_COLOR, dtype=I64, device=dev)

    def b(v):
        return v[:, None, None]

    def rect(img, x, y, w, h, packed, ok):
        m = ((xs >= b(x)) & (xs < b(x + w)) & (ys >= b(y)) & (ys < b(y + h))
             & b(ok))
        return torch.where(m, packed, img)

    # enemy formation: all enemies share the march offset of enemy 0
    show = (s.enemy_alive | (s.enemy_death_counter >= 0))
    rel_x = xs - b(s.enemy_x[:, 0])
    rel_y = ys - b(s.enemy_y[:, 0])
    in_sprite = ((rel_x >= 0) & (rel_y >= 0)
                 & (rel_x < N_COLS * ENEMY_DX) & (rel_y < N_ROWS * ENEMY_DY)
                 & (rel_x % ENEMY_DX < ENEMY_W) & (rel_y % ENEMY_DY < ENEMY_H))
    cell = ((rel_y // ENEMY_DY).clamp(0, N_ROWS - 1) * N_COLS
            + (rel_x // ENEMY_DX).clamp(0, N_COLS - 1))
    alive_px = show.gather(1, cell.reshape(n, -1).long()).view(cell.shape)
    img = torch.where(in_sprite & alive_px, ENEMY_COLOR, img)

    # shields: each pastes its pixel mask at its static position
    canvas = torch.zeros((n, HEIGHT, WIDTH), dtype=BOOL, device=dev)
    for i, (sx, sy) in enumerate(config.shield_pos):
        canvas[:, sy:sy + SHIELD_H, sx:sx + SHIELD_W] = s.shield_alpha[:, i]
    img = torch.where(canvas, SHIELD_COLOR, img)

    img = rect(img, s.ufo_x, s.ufo_y, ENEMY_W, ENEMY_H, UFO_COLOR,
               s.ufo_appearance_counter == 0)
    img = rect(img, s.ship_x, s.ship_y, SHIP_W, SHIP_H, SHIP_COLOR,
               s.ship_alive | (s.ship_death_counter >= 0))
    img = rect(img, s.ship_laser_x, s.ship_laser_y, LASER_W, LASER_H,
               LASER_COLOR, s.ship_laser_alive)
    for i in range(MAX_ENEMY_LASERS):
        img = rect(img, s.elaser_x[:, i], s.elaser_y[:, i], LASER_W, LASER_H,
                   LASER_COLOR, s.elaser_alive[:, i])
    return unpack_color(img)


# ---------------------------------------------------------------------------
# JSON codec (reference live-schema keys), one env at a time
# ---------------------------------------------------------------------------

_DIR_NAMES = ["Up", "Down", "Left", "Right"]


def _laser_json(x, y, t, movement, speed):
    return {
        "x": int(x), "y": int(y), "w": LASER_W, "h": LASER_H,
        "t": int(t), "movement": _DIR_NAMES[movement], "speed": speed,
        "color": {"r": 255, "g": 255, "b": 255, "a": 255},
    }


def _none_if_neg(v: int):
    return None if v < 0 else v


def state_to_json(config: Config, s: State, i: int = 0) -> dict:
    """The reference JSON state of env ``i``."""
    h = {f: getattr(s, f)[i].cpu().numpy() for f in FIELDS}
    rs = config.row_scores.cpu().numpy()
    enemies = []
    for e in range(N_ENEMIES):
        row, col = e // N_COLS, e % N_COLS
        enemies.append({
            "x": int(h["enemy_x"][e]), "y": int(h["enemy_y"][e]),
            "row": row, "col": col, "id": e,
            "alive": bool(h["enemy_alive"][e]),
            "points": int(rs[row]),
            "death_counter": _none_if_neg(int(h["enemy_death_counter"][e])),
        })
    r, g, b = SHIELD_COLOR & 0xFF, (SHIELD_COLOR >> 8) & 0xFF, \
        (SHIELD_COLOR >> 16) & 0xFF
    shields = []
    for k, (sx, sy) in enumerate(config.shield_pos):
        alpha = h["shield_alpha"][k]
        data = [[{"r": r, "g": g, "b": b, "a": 255 if alpha[y, x] else 0}
                 for x in range(SHIELD_W)] for y in range(SHIELD_H)]
        shields.append({"x": sx, "y": sy, "data": data})
    elasers = [_laser_json(h["elaser_x"][k], h["elaser_y"][k],
                           h["elaser_t"][k], DOWN_D, ENEMY_LASER_SPEED)
               for k in range(MAX_ENEMY_LASERS) if h["elaser_alive"][k]]
    return {
        "score": int(h["score"]),
        "lives": int(h["lives"]),
        "level": int(h["level"]),
        "rand": {"state": rng.to_u64_pair(h["rng"])},
        "life_display_timer": int(h["life_display_timer"]),
        "enemy_shot_delay": int(h["enemy_shot_delay"]),
        "ship": {
            "x": int(h["ship_x"]), "y": int(h["ship_y"]),
            "w": SHIP_W, "h": SHIP_H, "speed": 3,
            "color": {"r": 35, "g": 129, "b": 59, "a": 255},
            "alive": bool(h["ship_alive"]),
            "death_counter": _none_if_neg(int(h["ship_death_counter"])),
            "death_hit_1": bool(h["ship_death_hit_1"]),
        },
        "ship_laser": (_laser_json(h["ship_laser_x"], h["ship_laser_y"],
                                   h["ship_laser_t"], UP_D, SHIP_LASER_SPEED)
                       if bool(h["ship_laser_alive"]) else None),
        "enemy_lasers": elasers,
        "enemies": enemies,
        "enemies_movement": {
            "move_counter": int(h["move_counter"]),
            "move_dir": _DIR_NAMES[int(h["move_dir"])],
            "visual_orientation": bool(h["visual_orientation"]),
        },
        "shields": shields,
        "ufo": {
            "x": int(h["ufo_x"]), "y": int(h["ufo_y"]),
            "appearance_counter": int(h["ufo_appearance_counter"]),
            "death_counter": _none_if_neg(int(h["ufo_death_counter"])),
        },
    }

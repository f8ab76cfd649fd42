#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (toybox_tpu_torch) on one GPU.

    python3 chip_smoke.py

It drives the two paths of the port through the entry points a user
calls: the regress (serving) path of each ported game (Breakout, Space
Invaders, Amidar) with the game's committed PPO model, and PPO training
(``rl.ppo.learn``) over the pipeline's in-kernel warp, at the Breakout
recipe (1024 envs, NatureCNN, nsteps 128, 4 minibatches, 4 epochs).
Phases, each printing one line per game with its own wall time:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every frame kernel (csrc/*.cu) with nvcc, all at once, and
     load both entry points of each (frames, warped fused frames);
  3. each kernel against its plain PyTorch version on the card, single,
     fused and warped fused frames, at N = 10 (the serve), 256 and 1024
     envs, on random play and on doctored edge-case states:
     exactly equal; at N = 1024 the kernel's own device time
     (torch.profiler), the call's time (CUDA events, host dispatch
     included), the plain version's and the bound, and for the warp form
     the time of the path it replaces (fused kernel, then the two-matmul
     warp);
  4. the batched engine stepped on cuda and on cpu from the same seeds
     and actions: every state tensor bit-equal; the pipeline and the
     policy on cuda and on cpu: rewards equal, observations within 1 grey
     level, logits and values within 1e-4; the pipeline with
     inkernel_warp=True against False on the card: rewards, done and
     lives equal, observations within 1 grey level;
  5. serve (a main path): the committed PPO model through the regress
     entry point, 10 games for at most SERVE_STEPS agent steps, with the
     launch counts set to 0 just before and read just after; the game's
     frame kernels must have launched and the games must score;
  6. throughput: 1024 envs x 100 pipeline steps with the policy;
  7. a short torch.profiler window at 10 and 1024 envs: device kernels
     and device busy time per agent step;
  8. train (the slice's main path): ``learn`` on make_rl_env(game, 1024,
     inkernel_warp=True), 3 updates at the Breakout recipe and one shorter
     update (nsteps TRAIN_SHORT_STEPS) for Space Invaders and Amidar, with
     the launch counts set to 0 just before each and read just after:
     Breakout's warp kernel launches 3 x 128 times; metrics finite;
     seconds per update and frames/s; then one more Breakout update,
     train_step's collect and optimize halves timed apart, profiled (the
     warp kernel's device time a rollout step);
  9. one PPO update on cuda against cpu from the same params, batch and
     permutations: params within UPDATE_ATOL;
 10. the identity learning test on the card (mlp, 16 envs, 60 updates):
     mean reward > 0.8;
 11. the CLI: ``toybox_tpu_torch.run.main`` trains 2 updates at 64 envs
     and saves the policy, which reads back through the port's reader.

Then a JSON line of the kernels, the total time, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Convolutions and matmuls run in full f32 (TF32 off). Scratch files (the
CLI's log and model) go under build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from toybox_tpu_torch.core.actions import ale_to_input
from toybox_tpu_torch.envs.batched import make_batched_env
from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.games import amidar as am
from toybox_tpu_torch.games import breakout as bk
from toybox_tpu_torch.games import space_invaders as si
from toybox_tpu_torch import run
from toybox_tpu_torch.ops import obs, render_amidar, render_cuda, render_si
from toybox_tpu_torch.regress import full_f32, play_games
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.rl.policies import build_eval_policy, build_policy
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env

ROOT = Path(__file__).resolve().parent
MODELS = ROOT / "models"
SCRATCH = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM f32 rate outside the tensor cores
SERVE_GAMES, SERVE_STEPS = 10, 300
TRAIN_ENVS, TRAIN_UPDATES, TRAIN_SHORT_STEPS = 1024, 3, 32
RECIPE = dict(network="cnn", nsteps=128, nminibatches=4, noptepochs=4,
              lr=2.5e-4, cliprange=0.1, gamma=0.99, lam=0.95,
              ent_coef=0.01)                 # run.ALG_DEFAULTS["ppo"]
UPDATE_ENVS, UPDATE_STEPS, UPDATE_ATOL = 8, 8, 1e-5
CLI_ENVS = 64
WARP = 84
THROUGHPUT_ENVS, THROUGHPUT_STEPS = 1024, 100
ENGINE_ENVS, ENGINE_STEPS = 256, 200
PIPELINE_ENVS, PIPELINE_STEPS = 10, 40
PROFILE_STEPS = 10
KERNEL_ENVS = (SERVE_GAMES, 256, THROUGHPUT_ENVS)
DEV = "cuda"
PALLAS = "toybox_tpu/ops/render_pallas.py"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def phase(n: int, name: str, t0: float, detail: str) -> None:
    print(f"phase {n} {name}: {detail} ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms over iters launches (after warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, symbol: str, iters: int = 20, windows: int = 3) -> float:
    """Mean device time in ms of one launch of the CUDA kernel whose name
    holds `symbol`, from torch.profiler's kernel records over iters calls
    of fn() (after warm-up). The profiler may drop records, so the mean is
    over the records it kept, and a window in which it kept none is
    profiled again, up to `windows` in all; it fails if none kept one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and symbol in e.key]
        seen = sum(e.count for e in rows)
        if seen > 0:
            return sum(e.device_time_total for e in rows) / seen / 1e3
    check(False, f"the profiler kept no record of {symbol} in {windows} "
                 "windows")


def _rows(module, s, n: int):
    return module.State(**{f: getattr(s, f)[:n] for f in module.FIELDS})


def _random_play(module, cfg, n, steps, seed, fire_every=10, start=None):
    """States after `steps` frames of random play (FIRE every
    `fire_every` frames), from new games or from `start(state)`."""
    r = np.random.default_rng(seed)
    s = module.new_game(cfg, torch.arange(n, device=cfg.device) + seed)
    if start is not None:
        s = start(s)
    legal = np.asarray(module.LEGAL_ACTIONS)
    for i in range(steps):
        a = np.where(i % fire_every == 0, 1, r.choice(legal, n))
        s = module.step(cfg, s, ale_to_input(torch.as_tensor(
            a, device=cfg.device)))
    return s, r


def _next(module, cfg, s, r):
    return module.step(cfg, s, ale_to_input(torch.as_tensor(
        r.choice(np.asarray(module.LEGAL_ACTIONS), s.score.shape[0]),
        device=cfg.device)))


def breakout_states(cfg, n: int, seed: int):
    """Balls in play, bricks knocked out, env 0's paddle moved up, one env
    in every 7 waiting to serve."""
    s, r = _random_play(bk, cfg, n, 60, seed)
    alive = s.brick_alive & torch.as_tensor(
        r.random((n, bk.MAX_BRICKS)) > 0.3, device=cfg.device)
    py = s.paddle_y.clone()
    py[0] = 120.0
    wait = torch.zeros(n, dtype=torch.bool, device=cfg.device)
    wait[::7] = True
    s = s.replace(brick_alive=alive, paddle_y=py, reset=s.reset | wait)
    check(int((s.ball_alive & ~s.reset[:, None]).sum()) > 0,
          "no ball in play in the kernel test states")
    return s, _next(bk, cfg, s, r)


def si_states(cfg, n: int, seed: int):
    """The formation marching and thinned, lasers in flight, shields
    eroded, the UFO over the formation in one env in 5, the ship down in
    one env in 7."""
    def start(s):
        return s.replace(life_display_timer=torch.ones_like(s.lives))

    s, r = _random_play(si, cfg, n, 300, seed, fire_every=3, start=start)
    ufo = torch.zeros(n, dtype=torch.bool, device=cfg.device)
    ufo[::5] = True
    down = torch.zeros(n, dtype=torch.bool, device=cfg.device)
    down[::7] = True
    s = s.replace(
        ufo_appearance_counter=torch.where(ufo, 0, s.ufo_appearance_counter),
        ufo_x=torch.where(ufo, torch.as_tensor(
            r.integers(-10, 320, n), device=cfg.device,
            dtype=torch.int32), s.ufo_x),
        ship_alive=s.ship_alive & ~down,
        ship_death_counter=torch.where(down, -1, s.ship_death_counter))
    check(not bool(s.shield_alpha.all()), "no shield eroded")
    check(int((s.ship_laser_alive | s.elaser_alive.any(1)).sum()) > 0,
          "no laser in flight in the kernel test states")
    return s, _next(si, cfg, s, r)


def amidar_states(cfg, n: int, seed: int):
    """Tiles painted, enemies on their routes, a random third of the
    boxes painted (their interiors draw)."""
    s, r = _random_play(am, cfg, n, 150, seed)
    painted = s.box_painted | torch.as_tensor(
        r.random((n, am.MAX_BOXES)) > 0.7, device=cfg.device)
    s = s.replace(box_painted=painted)
    check(int((s.tiles == am.PAINTED).sum()) > int(
        (cfg.base_tiles == am.PAINTED).sum()) * n, "no tile painted")
    return s, _next(am, cfg, s, r)


def _cases(n: int, count: int, shift: int):
    """Env index masks of `count` cases, env i taking case
    (i + shift) % count."""
    case = (np.arange(n) + shift) % count
    return [case == k for k in range(count)]


def breakout_edge_fields(f: dict, shift: int = 0) -> dict:
    """Doctored Breakout states, as edits of a batch's fields (numpy
    arrays, the engine's State fields) -> the edited fields. Env i takes
    case (i + shift) % 8: the paddle straddling and past each frame edge
    and wall, its y moved by an intervention (0, 157, 300 and fractional),
    balls on fractional and integer edges and far off the frame (+-1e6),
    balls overlapping each other and the paddle, over bricks and over
    walls, balls hidden by `reset` and by `ball_alive`, all bricks gone in
    one env and all present in another."""
    f = {k: np.array(v) for k, v in f.items()}
    c = _cases(f["paddle_x"].shape[0], 8, shift)
    # (paddle x, width, y) and four balls (x, y) per case
    cases = [
        # 0: the paddle over the left and top frame edges; balls on the
        # left, right and bottom edges, at fractional coordinates
        ((5.0, 24.0, 0.0), [(-0.5, 20.0), (0.5, 60.0), (239.5, 100.0),
                            (120.0, 159.5)]),
        # 1: the paddle over the right and bottom edges; balls far off
        ((236.0, 24.0, 157.0), [(1e6, 50.0), (-1e6, 50.0), (100.0, 1e6),
                                (100.0, -1e6)]),
        # 2: two balls overlapping each other and the paddle, one on the
        # paddle's edge, one over the left wall
        ((100.0, 24.0, 143.0), [(100.0, 144.5), (101.5, 145.0),
                                (111.3, 142.7), (6.2, 90.0)]),
        # 3: the paddle past the right edge; balls over bricks, the top
        # wall and the right wall
        ((300.0, 24.0, 100.0), [(50.5, 45.0), (200.0, 130.0),
                                (20.0, 16.5), (233.7, 80.2)]),
        # 4: the paddle past the left edge; the balls waiting to be served
        ((-30.0, 24.0, 50.0), [(60.0, 60.0), (70.0, 70.0), (80.0, 80.0),
                               (90.0, 90.0)]),
        # 5: the paddle from x = 0 exactly over the left wall, straddling
        # the top wall at a fractional y; no ball alive
        ((12.0, 24.0, 14.5), [(60.0, 60.0), (70.0, 70.0), (80.0, 80.0),
                              (90.0, 90.0)]),
        # 6: all bricks gone; the paddle over the right wall and past the
        # bottom; balls on integer edges: the frame's corners and the
        # brick band's
        ((228.0, 24.0, 300.0), [(2.0, 2.0), (238.0, 158.0), (12.0, 43.0),
                                (228.0, 139.0)]),
        # 7: all bricks present; a paddle wider than the frame over the top
        # edge; balls over the top-left and bottom-right corners and over
        # the paddle
        ((120.0, 1000.0, -2.0), [(3.5, 0.5), (236.5, 159.0), (116.0, 1.0),
                                 (-1.5, 158.5)]),
    ]
    for k, ((px, width, py), balls) in enumerate(cases):
        f["paddle_x"][c[k]] = px
        f["paddle_width"][c[k]] = width
        f["paddle_y"][c[k]] = py
        f["ball_x"][c[k]] = [x for x, _ in balls]
        f["ball_y"][c[k]] = [y for _, y in balls]
        f["ball_alive"][c[k]] = k != 5
        f["reset"][c[k]] = k == 4
    f["brick_alive"][c[6]] = False
    f["brick_alive"][c[7]] = f["brick_exists"][c[7]]
    return f


def si_edge_fields(f: dict, shift: int = 0) -> dict:
    """Doctored Space Invaders states, as edits of a batch's fields (numpy
    arrays, the engine's State fields) -> the edited fields. Env i takes
    case (i + shift) % 8: sprites straddling each frame edge and past it,
    the formation anchor pushing cells past the left, right, top and
    bottom edges (and far off the frame), lasers over the ship and over
    the shields, half-eroded shields, hidden sprites."""
    f = {k: np.array(v) for k, v in f.items()}
    c = _cases(f["ufo_x"].shape[0], 8, shift)
    n_sh = f["shield_alpha"].shape[1]

    def put(name, case, value, col=slice(None)):
        a = f[name]
        if a.ndim == 1:
            a[case] = value
        else:
            a[case, col] = value

    for k, (ax, ay) in enumerate([(-40, 20), (250, -20), (3, 150), (-60, 40),
                                  (290, 100), (-300, 500), (1, -107),
                                  (319, 209)]):
        put("enemy_x", c[k], ax, 0)
        put("enemy_y", c[k], ay, 0)
    show = np.arange(36) % 5 != 2               # a thinned formation
    f["enemy_alive"][c[0] | c[1] | c[4]] = show
    f["enemy_death_counter"][c[0] | c[1] | c[4]] = -1
    # case 0: UFO over the left edge, ship over the right, lasers over the
    # top and bottom edges and past the right
    put("ufo_appearance_counter", c[0], 0)
    put("ufo_x", c[0], -7)
    put("ufo_y", c[0], 30)
    put("ship_alive", c[0], True)
    put("ship_x", c[0], 312)
    put("ship_y", c[0], 185)
    put("elaser_alive", c[0], True)
    for j, (x, y) in enumerate([(100, -3), (120, 206), (321, 50), (-2, 60)]):
        put("elaser_x", c[0], x, j)
        put("elaser_y", c[0], y, j)
    # case 1: UFO past the top, ship over the bottom edge, UFO over the
    # formation
    put("ufo_appearance_counter", c[1], 0)
    put("ufo_x", c[1], 150)
    put("ufo_y", c[1], -12)
    put("ship_alive", c[1], True)
    put("ship_x", c[1], 0)
    put("ship_y", c[1], 205)
    # case 2: lasers over the ship, the ship at the left edge
    put("ship_alive", c[2], True)
    put("ship_x", c[2], 40)
    put("ship_y", c[2], 185)
    put("ship_laser_alive", c[2], True)
    put("ship_laser_x", c[2], 47)
    put("ship_laser_y", c[2], 183)
    put("elaser_alive", c[2], True)
    for j, (x, y) in enumerate([(40, 190), (54, 180), (38, 186), (55, 194)]):
        put("elaser_x", c[2], x, j)
        put("elaser_y", c[2], y, j)
    # case 3: lasers over the shields, the shields half eroded
    put("ship_laser_alive", c[3], True)
    put("ship_laser_x", c[3], 90)
    put("ship_laser_y", c[3], 160)
    put("elaser_alive", c[3], True)
    for j, (x, y) in enumerate([(147, 155), (163, 170), (226, 168),
                                (83, 172)]):
        put("elaser_x", c[3], x, j)
        put("elaser_y", c[3], y, j)
    alpha = f["shield_alpha"]
    rows = np.arange(alpha.shape[2])[:, None]
    cols = np.arange(alpha.shape[3])[None, :]
    for s in range(n_sh):
        alpha[c[3], s] &= [cols >= 8, rows < 9, (rows + cols) % 2 == 0][s % 3]
    alpha[c[4], :, :, :8] = False
    # case 4: hidden sprites over the formation and the shields
    put("ufo_appearance_counter", c[4], 5)
    put("ufo_x", c[4], 100)
    put("ufo_y", c[4], 110)
    put("ship_alive", c[4], False)
    put("ship_death_counter", c[4], -1)
    put("ship_laser_alive", c[4], False)
    put("ship_laser_x", c[4], 90)
    put("ship_laser_y", c[4], 160)
    put("elaser_alive", c[4], False)
    put("elaser_x", c[4], 300)
    put("elaser_y", c[4], 110)
    # case 5: UFO over the right edge, the ship half past the bottom
    put("ufo_appearance_counter", c[5], 0)
    put("ufo_x", c[5], 310)
    put("ufo_y", c[5], 0)
    put("ship_alive", c[5], True)
    put("ship_x", c[5], 100)
    put("ship_y", c[5], 215)
    # case 6: the top-left corner: one pixel of the UFO and of a laser
    put("ufo_appearance_counter", c[6], 0)
    put("ufo_x", c[6], -15)
    put("ufo_y", c[6], -9)
    put("elaser_alive", c[6], True)
    put("elaser_x", c[6], -1, 0)
    put("elaser_y", c[6], -7, 0)
    # case 7: the bottom-right corner, the ship dying (still drawn)
    put("ufo_appearance_counter", c[7], 0)
    put("ufo_x", c[7], 319)
    put("ufo_y", c[7], 209)
    put("ship_alive", c[7], False)
    put("ship_death_counter", c[7], 10)
    put("ship_x", c[7], 305)
    put("ship_y", c[7], 201)
    return f


def amidar_edge_fields(f: dict, shift: int = 0) -> dict:
    """Doctored Amidar states, as edits of a batch's fields (numpy arrays,
    world coordinates: pixel = origin + world // 16) -> the edited fields.
    Env i takes case (i + shift) % 6: enemies and the player straddling
    each frame edge and past it, at the board's four corners overlapping
    each other and the player, on negative and unaligned world
    coordinates, and hidden enemies on the player."""
    f = {k: np.array(v) for k, v in f.items()}
    c = _cases(f["player_x"].shape[0], 6, shift)

    def world(px, origin):
        return (np.asarray(px) - origin) * 16

    def place(case, enemies, player, exists=True):
        ex, ey = zip(*enemies)
        f["enemy_x"][case] = world(ex, 16)
        f["enemy_y"][case] = world(ey, 45)
        f["enemy_exists"][case] = exists
        f["player_x"][case] = world(player[0], 16)
        f["player_y"][case] = world(player[1], 45)

    # 0: each frame edge, straddled and passed
    place(c[0], [(-2, 100), (158, 120), (60, -3), (80, 247), (-5, 10),
                 (161, 30), (100, -6), (20, 251)], (157, -2))
    # 1: the board's top-left corner, all overlapping the player
    place(c[1], [(16, 45), (17, 45), (16, 46), (18, 47), (15, 44), (19, 49),
                 (14, 45), (16, 43)], (17, 46))
    # 2: the board's bottom-right corner (board x < 144, y < 200)
    place(c[2], [(140, 195), (141, 196), (142, 197), (143, 198), (144, 199),
                 (139, 200), (141, 195), (138, 194)], (141, 197))
    # 3: the top-right and bottom-left corners
    place(c[3], [(140, 45), (141, 44), (142, 46), (143, 43), (16, 195),
                 (15, 196), (14, 197), (17, 199)], (14, 198))
    # 4: hidden enemies on the player, one shown beside it
    place(c[4], [(70, 100)] * 7 + [(73, 103)], (70, 100),
          exists=np.arange(8) == 7)
    # 5: world coordinates that are negative and not multiples of 16
    f["enemy_x"][c[5]] = [-1, -17, -300, 5, 2047, 2049, 15, -16]
    f["enemy_y"][c[5]] = [-1, -730, 2495, 3, 15, 17, -721, 2490]
    f["enemy_exists"][c[5]] = True
    f["player_x"][c[5]] = -257
    f["player_y"][c[5]] = 2479
    return f


def _edge_states(module, edit):
    """`edit` (a function of numpy fields and a case shift) applied to a
    torch state."""
    def apply(s, shift=0):
        fields = {k: getattr(s, k).cpu().numpy() for k in module.FIELDS}
        dev = s.score.device
        return s.replace(**{k: torch.as_tensor(v, device=dev)
                            for k, v in edit(fields, shift).items()})
    return apply


@dataclasses.dataclass(frozen=True)
class Game:
    """One ported game: its engine, model, frame kernel and checks."""
    name: str
    module: object
    model: str
    kernel: str                  # csrc/<kernel>.cu
    replaces: tuple              # render_pallas.py lines: single, fused
                                 # (the warp form is the fused renderer's)
    ops: object                  # module with render_frames, frame_plain
    prep: object                 # (config, state) -> f32[N, P]
    consts: object               # config -> kernel constants
    states: object               # (config, n, seed) -> (s1, s2)
    edges: object = None         # state -> doctored state (edge cases)


GAMES = (
    Game("breakout", bk, "Breakout.regress.model", "breakout_frame",
         (307, 324), render_cuda, lambda c, s: render_cuda.breakout_prep(s),
         render_cuda.breakout_lumas, breakout_states,
         _edge_states(bk, breakout_edge_fields)),
    Game("space_invaders", si, "SpaceInvaders.regress.model", "si_frame",
         (710, 722), render_si, lambda c, s: render_si.si_prep(s),
         render_si.si_consts, si_states,
         _edge_states(si, si_edge_fields)),
    Game("amidar", am, "Amidar.regress.model", "amidar_frame", (475, 489),
         render_amidar, render_amidar.amidar_prep,
         render_amidar.amidar_consts, amidar_states,
         _edge_states(am, amidar_edge_fields)),
)


def _bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_phase(g: Game):
    """Exact comparison at the main paths' shapes, on random play and, for
    games with edge cases, on doctored states (each env's two frames take
    different cases); times at N = 1024."""
    cfg = g.module.default_config(DEV)
    consts = g.consts(cfg)
    h, w = g.module.HEIGHT, g.module.WIDTH
    tables = obs.warp_tables(h, w, WARP, DEV)
    s1, s2 = g.states(cfg, THROUGHPUT_ENVS, 1)
    sets = [("random play", s1, s2)]
    if g.edges is not None:
        sets.append(("edge cases", g.edges(s1), g.edges(s2, shift=1)))
    names = (g.kernel, g.kernel + "_fused", g.kernel + "_fused_warp")
    err = {k: 0 for k in names}
    preps = {}
    for label, a, b in sets:
        for n in KERNEL_ENVS:
            p1 = g.prep(cfg, _rows(g.module, a, n))
            p2 = g.prep(cfg, _rows(g.module, b, n))
            pair = torch.stack([p1, p2], 1)
            for name, prep, tab in zip(names, (p1[:, None], pair, pair),
                                       (None, None, tables)):
                got = g.ops.render_frames(prep, consts, tab)
                want = (g.ops.frame_plain(prep, consts) if tab is None
                        else g.ops.frame_warp_plain(prep, consts, tab))
                torch.cuda.synchronize()
                diff = int((got.int() - want.int()).abs().max())
                check(diff == 0, f"{name} differs from its plain version by "
                                 f"{diff} at N={n} on {label}")
                err[name] = max(err[name], diff)
                if label == "random play":
                    preps[name] = prep
    timing = {}
    for name, prep in preps.items():
        n, frames = prep.shape[0], prep.shape[1]
        # one select per pixel and frame, one max per pixel for two frames
        n_ops = n * h * w * (2 * frames - 1)
        tab = tables if name.endswith("_warp") else None
        if tab is None:
            n_bytes = prep.numel() * 4 + n * h * w
            plain = lambda: g.ops.frame_plain(prep, consts)  # noqa: E731
        else:
            # the banded sums: one multiply and one add per tap
            taps = tab.taps[:, :, 1].sum(1).tolist()
            n_ops += n * 2 * (taps[0] * w + taps[1] * WARP)
            n_bytes = prep.numel() * 4 + n * WARP * WARP
            plain = lambda: g.ops.frame_warp_plain(  # noqa: E731
                prep, consts, tab)
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        call = lambda: g.ops.render_frames(prep, consts, tab)  # noqa: E731
        symbol = g.kernel + ("_warp" if tab is not None else "") + "_kernel"
        timing[name] = dict(
            ms=kernel_ms(call, symbol), call_ms=cuda_ms(call),
            plain_ms=cuda_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
            n=n)
    # the path the warp form replaces: the fused kernel, then two matmuls
    warp = obs.make_warp(h, w, WARP, DEV)
    pair = preps[names[1]]
    timing[names[2]]["replaced_ms"] = cuda_ms(
        lambda: warp(g.ops.render_frames(pair, consts)))
    return [label for label, _, _ in sets], err, timing


def _engine_start(g: Game, st, d):
    """Breakout: half the envs start with the low rows gone, so their
    balls reach the deep rows early and take the speed-up rescale. Space
    Invaders: no intro pause. Amidar and Space Invaders: one life left, so
    games end and reset inside the run."""
    game = st.game
    idx = torch.arange(ENGINE_ENVS, device=d)
    if g.name == "breakout":
        low = (game.brick_depth < 3) & (idx % 2 == 0)[:, None]
        game = game.replace(brick_alive=game.brick_alive & ~low)
    else:
        game = game.replace(lives=torch.ones_like(game.lives))
    if g.name == "space_invaders":
        game = game.replace(life_display_timer=torch.ones_like(game.lives))
    return dataclasses.replace(st, game=game)


def engine_phase(g: Game) -> str:
    """Batched engine (with auto-reset) on cuda and on cpu, bit-equal."""
    envs = {d: make_batched_env(g.name, ENGINE_ENVS, fast_auto_reset=True,
                                device=d) for d in (DEV, "cpu")}
    seeds = np.arange(ENGINE_ENVS) + 100
    states = {d: _engine_start(g, env.reset(torch.as_tensor(
        seeds, device=d))[0], d) for d, env in envs.items()}
    n_act = envs["cpu"].num_actions
    r = np.random.default_rng(7)
    steps = ENGINE_STEPS if g.name == "breakout" else 2 * ENGINE_STEPS
    n_done = 0
    for i in range(steps):
        a = r.integers(0, n_act, size=ENGINE_ENVS)
        a[r.random(ENGINE_ENVS) < 0.3] = 1          # FIRE (or jump) often
        out = {}
        for d, env in envs.items():
            states[d], _, rew, done, _ = env.step(
                states[d], torch.as_tensor(a, device=d))
            out[d] = (rew, done)
        if i % 10 == 9 or i == steps - 1:
            for f in g.module.FIELDS:
                c, h = (getattr(states[d].game, f).cpu() for d in
                        (DEV, "cpu"))
                check(torch.equal(c, h), f"{g.name} engine field {f} differs "
                                         f"between cuda and cpu at step {i}")
            for k in (0, 1):
                check(torch.equal(out[DEV][k].cpu(), out["cpu"][k]),
                      f"{g.name} reward/done differ between cuda and cpu at "
                      f"step {i}")
            check(torch.equal(states[DEV].seeds.cpu(), states["cpu"].seeds),
                  f"{g.name} reseeds differ")
        n_done += int(out["cpu"][1].sum())
    gs = states["cpu"].game
    detail = (f"{g.name} {ENGINE_ENVS} envs x {steps} steps bit-equal; "
              f"{n_done} game overs, score {int(gs.score.sum())}")
    if g.name == "breakout":
        speed = torch.sqrt(gs.ball_vx ** 2 + gs.ball_vy ** 2)
        fast = int(((speed > 3.0) & gs.ball_alive).any(1).sum())
        check(fast > 0, "no env took the speed-up rescale")
        detail += f", {fast} envs with fast balls"
    else:
        check(n_done > 0, f"no {g.name} game ended in the engine run")
    return detail


def _policy_run(g: Game, state_dict, n: int, device: str):
    env = make_rl_env(g.name, n, device=device)
    module, p_step = build_eval_policy("ppo", env.obs_shape, env.num_actions,
                                       "cnn", device=device)
    module.load_state_dict(state_dict)
    return env, module, p_step


def pipeline_phase(g: Game, state_dict) -> str:
    """The DeepMind pipeline and the policy on cuda against cpu, on the
    same seeds and actions: reward, done and lives exact, observations
    within 1 grey level (the warp's matmul sums in another order), logits
    and values within 1e-4 on the same observations."""
    n = PIPELINE_ENVS
    runs = {d: _policy_run(g, state_dict, n, d) for d in (DEV, "cpu")}
    states = {d: run[0].reset(torch.arange(n, device=d))[0]
              for d, run in runs.items()}
    n_act = runs["cpu"][0].num_actions
    r = np.random.default_rng(5)
    obs_diff, logit_diff, reward = 0, 0.0, 0.0
    for i in range(PIPELINE_STEPS):
        a = r.integers(0, n_act, size=n)
        a[r.random(n) < 0.4] = 1
        out = {}
        for d, (env, _, _) in runs.items():
            states[d], obs, rew, done, info = env.step(
                states[d], torch.as_tensor(a, device=d))
            out[d] = (obs, rew, done, info["lives"])
        for k in (1, 2, 3):
            check(torch.equal(out[DEV][k].cpu(), out["cpu"][k]),
                  f"{g.name} pipeline reward/done/lives differ at step {i}")
        obs_diff = max(obs_diff, int((out[DEV][0].cpu().int()
                                      - out["cpu"][0].int()).abs().max()))
        reward += float(out["cpu"][1].sum())
        with torch.no_grad():
            obs = out["cpu"][0]
            lc, vc = runs[DEV][1](obs.to(DEV))
            lp, vp = runs["cpu"][1](obs)
        logit_diff = max(logit_diff, float((lc.cpu() - lp).abs().max()),
                         float((vc.cpu() - vp).abs().max()))
    check(obs_diff <= 1, f"{g.name} pipeline obs differ by {obs_diff} grey "
                         "levels")
    check(logit_diff <= 1e-4, f"{g.name} policy differs by {logit_diff}")
    return (f"{g.name} pipeline {n} envs x {PIPELINE_STEPS} steps: "
            f"reward/done/lives equal (reward {reward}), obs max diff "
            f"{obs_diff}; policy max diff {logit_diff:.2e}")


def serve_phase(g: Game, state_dict):
    """The main path: the regress entry point's play_games with the
    committed model, the launch counts set to 0 just before it and read
    just after."""
    chunks = []
    for k in render_cuda.LAUNCHES:
        render_cuda.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    scores = play_games(g.name, state_dict, "cnn", SERVE_GAMES, chunk=100,
                        device=DEV, max_frames=4 * SERVE_STEPS,
                        on_chunk=lambda steps, tot: chunks.append(
                            (steps, float(tot.sum()))))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(render_cuda.LAUNCHES)
    mine = {k: launches[k] for k in (g.kernel, g.kernel + "_fused")}
    check(all(v > 0 for v in mine.values()),
          f"a {g.name} frame kernel did not launch in the serve: {launches}")
    check(float(scores.sum()) > 0 and np.isfinite(scores).all(),
          f"{g.name} serve scored {scores.tolist()}")
    steps = chunks[-1][0]
    so_far = " ".join(f"{k}:{v:g}" for k, v in chunks)
    detail = (f"{g.name} {SERVE_GAMES} games, {steps} agent steps, total "
              f"score so far by agent step {so_far}; scores "
              f"{scores.tolist()}, mean {float(scores.mean()):.1f}, "
              f"{steps / dt:.1f} agent-steps/s, launches {launches}")
    return mine, detail


def throughput_phase(g: Game, state_dict, kernel_ms: float) -> str:
    """1024 envs x 100 pipeline steps with the policy sampling actions."""
    n = THROUGHPUT_ENVS
    env, _, p_step = _policy_run(g, state_dict, n, DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    st, _ = env.reset(torch.arange(n, device=DEV))
    for _ in range(3):
        actions, _, _, _ = p_step(st.frames, gen)
        st, _, _, _, _ = env.step(st, actions)
    torch.cuda.synchronize()
    key = g.kernel + "_fused"
    before = render_cuda.LAUNCHES[key]
    t1 = time.perf_counter()
    for _ in range(THROUGHPUT_STEPS):
        actions, _, _, _ = p_step(st.frames, gen)
        st, obs, _, _, _ = env.step(st, actions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    fused = render_cuda.LAUNCHES[key] - before
    check(tuple(obs.shape) == (n, 84, 84, 4), f"obs shape {obs.shape}")
    share = fused * kernel_ms / (wall * 1e3)
    return (f"{g.name} {n} envs x {THROUGHPUT_STEPS} steps in {wall:.3f} s: "
            f"{n * THROUGHPUT_STEPS * 4 / wall:.0f} frames/s, "
            f"{n * THROUGHPUT_STEPS / wall:.0f} agent-steps/s; fused kernel "
            f"~{100 * share:.2f}% of the time ({fused} launches x phase-3 "
            f"kernel time)")


def profile_phase(g: Game, state_dict, n: int, steps: int) -> str:
    """Device time of `steps` agent steps (policy + pipeline) at n envs,
    from torch.profiler's CUDA kernel records, against the same window's
    wall time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    env, _, p_step = _policy_run(g, state_dict, n, DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    st, _ = env.reset(torch.arange(n, device=DEV))

    def window(st):
        for _ in range(steps):
            actions, _, _, _ = p_step(st.frames, gen)
            st, _, _, _, _ = env.step(st, actions)
        torch.cuda.synchronize()
        return st

    st = window(st)
    t1 = time.perf_counter()
    st = window(st)
    wall_us = (time.perf_counter() - t1) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window(st)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return (f"{g.name} {n} envs: {wall_us / steps / 1e3:.2f} ms/agent "
                "step; device time not measured (no CUDA records)")
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    frame = sum(e.time_range.elapsed_us() for e in kernels
                if g.kernel in e.name)
    return (f"{g.name} {n} envs: {wall_us / steps / 1e3:.2f} ms/agent step, "
            f"{len(kernels) / steps:.0f} device kernels/step, device busy "
            f"{busy / steps:.0f} us/step ({100 * busy / wall_us:.1f}% of the "
            f"unprofiled step), frame kernel {frame / steps:.1f} us/step")


def warp_pipeline_phase(g: Game) -> str:
    """The pipeline with inkernel_warp=True against False on the card, on
    the same seeds and actions: reward, done and lives exact, observations
    within 1 grey level (the banded sums and the matmuls sum in other
    orders)."""
    n = PIPELINE_ENVS
    envs = {w: make_rl_env(g.name, n, inkernel_warp=w, device=DEV)
            for w in (True, False)}
    states = {w: e.reset(torch.arange(n, device=DEV))[0]
              for w, e in envs.items()}
    n_act = envs[True].num_actions
    r = np.random.default_rng(6)
    worst, differ = 0, 0
    for i in range(PIPELINE_STEPS):
        a = r.integers(0, n_act, size=n)
        a[r.random(n) < 0.4] = 1
        out = {}
        for w, env in envs.items():
            states[w], o, rew, done, info = env.step(
                states[w], torch.as_tensor(a, device=DEV))
            out[w] = (o, rew, done, info["lives"])
        for k in (1, 2, 3):
            check(torch.equal(out[True][k], out[False][k]),
                  f"{g.name} inkernel_warp changes reward/done/lives at "
                  f"step {i}")
        diff = (out[True][0].int() - out[False][0].int()).abs()
        worst = max(worst, int(diff.max()))
        differ += int((diff > 0).sum())
    check(worst <= 1, f"{g.name} inkernel_warp obs differ by {worst}")
    total = n * PIPELINE_STEPS * WARP * WARP * 4
    return (f"{g.name} inkernel_warp=True vs False, {n} envs x "
            f"{PIPELINE_STEPS} steps: reward/done/lives equal, obs max diff "
            f"{worst}, {differ} of {total} obs pixels differ")


class _Rows:
    """A logger for ``learn``: one dict per update, stamped with the host
    clock when the update's metrics were read (learn reads them as
    floats, which waits for the device)."""

    def __init__(self):
        self.rows, self.row = [], {}

    def logkv(self, key, value):
        self.row[key] = value

    def dumpkvs(self):
        self.row["wall"] = time.perf_counter()
        self.rows.append(self.row)
        self.row = {}


def _reset_launches() -> None:
    for k in render_cuda.LAUNCHES:
        render_cuda.LAUNCHES[k] = 0


def train_phase(g: Game, nsteps: int, updates: int):
    """A main path: ``learn`` on make_rl_env(game, TRAIN_ENVS,
    inkernel_warp=True) with the ppo defaults, the launch counts set to 0
    just before and read just after. Returns (launches, detail, seconds
    per update)."""
    env = make_rl_env(g.name, TRAIN_ENVS, inkernel_warp=True, device=DEV)
    log = _Rows()
    nbatch = TRAIN_ENVS * nsteps
    _reset_launches()
    t0 = time.perf_counter()
    state = ppo.learn(env=env, total_timesteps=updates * nbatch * 4,
                      seed=0, logger=log, device=DEV,
                      **dict(RECIPE, nsteps=nsteps))
    torch.cuda.synchronize()
    launches = dict(render_cuda.LAUNCHES)
    warp = g.kernel + "_fused_warp"
    check(launches[warp] == updates * nsteps,
          f"{warp} launched {launches[warp]} times in {updates} updates of "
          f"{nsteps} steps: {launches}")
    check(launches[g.kernel + "_fused"] == 0,
          f"the unwarped fused kernel ran on the warp path: {launches}")
    check(state.update == updates and len(log.rows) == updates,
          f"{g.name} trained {state.update} updates")
    for row in log.rows:
        for k in ppo.METRICS + ("mean_reward",):
            key = f"loss/{k}" if k in ppo.METRICS else k
            check(math.isfinite(row[key]), f"{g.name} {key} = {row[key]}")
    walls = [t0] + [row["wall"] for row in log.rows]
    secs = [b - a for a, b in zip(walls, walls[1:])]
    steady = secs[1:] if len(secs) > 1 else secs
    per_update = sum(steady) / len(steady)
    last = log.rows[-1]
    detail = (f"{g.name} {TRAIN_ENVS} envs x nsteps {nsteps}, {updates} "
              f"updates: s/update " + ", ".join(f"{x:.2f}" for x in secs)
              + f" (steady {per_update:.2f} s: "
              f"{nbatch * 4 / per_update:.0f} frames/s, "
              f"{nbatch / per_update:.0f} agent-steps/s); last update "
              + ", ".join(f"{k} {last[k]:.4g}" for k in (
                  "loss/policy_loss", "loss/value_loss",
                  "loss/policy_entropy", "loss/approxkl", "loss/clipfrac",
                  "mean_reward", "eprewmean", "episodes"))
              + f"; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"launches {launches}")
    del state, env
    return launches, detail, per_update


def train_profile_phase() -> str:
    """One more Breakout update at the recipe through make_ppo's
    train_step, its two halves timed apart on the host clock, each to a
    sync: ``collect`` (the rollout and GAE) and ``optimize`` (the
    minibatch epochs). Then torch.profiler over the collect half of an
    8-step train_step and over the optimize half at the recipe (again on
    the same batch): device busy share and the largest device kernels."""
    from torch.profiler import ProfilerActivity, profile

    env = make_rl_env("breakout", TRAIN_ENVS, inkernel_warp=True, device=DEV)

    def trainer(nsteps):
        init_fn, train_step, _ = ppo.make_ppo(
            env, device=DEV, **dict(RECIPE, nsteps=nsteps))
        return init_fn(0), train_step

    state, train_step = trainer(RECIPE["nsteps"])
    t0 = time.perf_counter()
    collected = train_step.collect(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    train_step.optimize(state, collected)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def busy(fn, label, steps=0):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e6
        ks = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if not ks:
            return f"{label}: device time not measured (no CUDA records)"
        total = sum(e.time_range.elapsed_us() for e in ks)
        by = {}
        for e in ks:
            by[e.name] = by.get(e.name, 0) + e.time_range.elapsed_us()
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        warp = sum(v for k, v in by.items() if "breakout_frame_warp" in k)
        return (f"{label}: {len(ks)} device kernels, device busy {total:.0f}"
                f" us of {wall:.0f} us profiled ({100 * total / wall:.1f}%); "
                "largest " + ", ".join(f"{k[:48]} {v:.0f} us"
                                       for k, v in top)
                + (f"; the warp kernel {warp / steps:.1f} us a rollout step"
                   if steps else ""))

    short, short_step = trainer(8)
    detail = (f"breakout {TRAIN_ENVS} envs, one train_step split: collect "
              f"({RECIPE['nsteps']} rollout steps + GAE) {t1 - t0:.2f} s, "
              f"optimize ({RECIPE['noptepochs']} epochs x "
              f"{RECIPE['nminibatches']} minibatches) {t2 - t1:.2f} s; "
              + busy(lambda: short_step.collect(short),
                     "collect of 8 rollout steps", 8) + "; "
              + busy(lambda: train_step.optimize(state, collected),
                     f"optimize, {RECIPE['noptepochs']} epochs"))
    del collected, state, short, env
    return detail


def update_phase() -> str:
    """One PPO update on cuda and on cpu from the same params, batch and
    permutations: a make_ppo on the cpu collects the batch (its
    train_step's collect half), then ``ppo.update`` runs on each device.
    The params after it agree within UPDATE_ATOL (cuDNN and the CPU sum
    the convolutions' gradients in other orders)."""
    n, nsteps = UPDATE_ENVS, UPDATE_STEPS
    env = make_rl_env("breakout", n, device="cpu")
    init_fn, train_step, _ = ppo.make_ppo(env, nsteps=nsteps, device="cpu")
    state = init_fn(0)
    before = {k: v.clone() for k, v in state.module.state_dict().items()}
    batch, _ = train_step.collect(state)
    module, p_init, _, _ = build_policy(env.obs_shape, env.num_actions,
                                        "cnn", device=DEV)
    p_init(0)
    for k, v in module.state_dict().items():
        check(torch.equal(v.cpu(), before[k]), f"init differs: {k}")
    mods = {DEV: module, "cpu": state.module}
    perms = [torch.randperm(n * nsteps, generator=state.generator)
             for _ in range(4)]
    hp = ppo.Hyper(nminibatches=4)
    lrnow, cliprnow = ppo.anneal(0, 1, 2.5e-4, 0.1)
    metrics = {}
    for d, module in mods.items():
        metrics[d] = ppo.update(
            module, ppo.AdamState.zeros_like(list(module.parameters())),
            tuple(x.to(d) for x in batch), [p.to(d) for p in perms],
            lrnow, cliprnow, hp, env.num_actions)
    after = {d: {k: v.cpu() for k, v in m.state_dict().items()}
             for d, m in mods.items()}
    moved = max(float((after["cpu"][k] - before[k]).abs().max())
                for k in before)
    diff = max(float((after[DEV][k] - after["cpu"][k]).abs().max())
               for k in before)
    check(moved > 1e-4, f"the update moved the params by only {moved}")
    check(diff <= UPDATE_ATOL, f"cuda and cpu updates differ by {diff}")
    mdiff = max(abs(float(metrics[DEV][k]) - float(metrics["cpu"][k]))
                for k in ppo.METRICS)
    return (f"breakout {n} envs x nsteps {nsteps}, 4 epochs x 4 "
            f"minibatches: params moved up to {moved:.3g}, cuda vs cpu max "
            f"diff {diff:.3g} (tolerance {UPDATE_ATOL:g}); metrics max diff "
            f"{mdiff:.3g}")


def identity_phase() -> str:
    """tests/test_rl_learning.py's identity learning test on the card."""
    env = make_discrete_identity_env(16, dim=4, device=DEV)
    init_fn, train_step, _ = ppo.make_ppo(
        env, network="mlp", nsteps=16, nminibatches=2, noptepochs=2,
        lr=1e-2, cliprange=0.2, total_updates=60,
        network_kwargs=dict(num_hidden=32), device=DEV)
    state = init_fn(0)
    for _ in range(60):
        state, metrics = train_step(state)
    r = float(metrics["mean_reward"])
    check(r > 0.8, f"ppo failed to learn the identity task: {r}")
    return f"mlp, 16 envs, 60 updates: mean reward {r:.3f} (> 0.8)"


def cli_phase() -> str:
    """``python -m toybox_tpu_torch.run --alg=ppo`` at CLI_ENVS envs for 2
    updates, saving the policy; the file reads back through the port's
    reader with the trained params."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    SCRATCH.mkdir(parents=True)
    path = SCRATCH / "breakout.model"
    n = CLI_ENVS
    steps = 2 * n * run.ALG_DEFAULTS["ppo"]["nsteps"] * 4
    state = run.main(["--alg=ppo", "--env=BreakoutToyboxNoFrameskip-v4",
                      f"--num_envs={n}", f"--num_timesteps={steps}",
                      f"--save_path={path}", f"--log_path={SCRATCH / 'log'}",
                      f"--device={DEV}"])
    check(state.update == 2, f"the CLI trained {state.update} updates")
    module = build_policy((84, 84, 4), state.module.pi.out_features, "cnn",
                          device="cpu")[0]
    ppo.load_params(path, module)
    for k, v in state.module.state_dict().items():
        check(torch.equal(module.state_dict()[k], v.cpu()),
              f"the saved policy differs in {k}")
    rows = (SCRATCH / "log" / "progress.csv").read_text().splitlines()
    check(len(rows) == 3, f"progress.csv has {len(rows)} lines")
    return (f"run.main --alg=ppo --num_envs={n} --num_timesteps={steps}: "
            f"{state.update} updates, {path.stat().st_size} B saved and read "
            f"back equal; progress.csv {len(rows) - 1} rows")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    full_f32()

    # 1. the card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    phase(1, "device", t0, f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")

    # 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    built = render_cuda.build()
    check({g.kernel for g in GAMES} <= set(built),
          f"kernels missing from the build: {sorted(built)}")
    for g in GAMES:
        render_cuda.load_library(g.kernel)
        render_cuda.load_library(g.kernel, warp=True)
    phase(2, "build", t0, "; ".join(
        f"{path.name} [" + (" | ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line) or "cached") + "]"
        for path, log in built.values()))

    # 3. kernels against their plain versions
    err, timing = {}, {}
    for g in GAMES:
        t0 = time.perf_counter()
        sets, e, t = kernel_phase(g)
        err.update(e)
        timing.update(t)
        phase(3, "kernel", t0, "exact at N=" + ",".join(
            map(str, KERNEL_ENVS)) + " on " + " and ".join(sets) + "; "
              + "; ".join(
                  f"{k} N={v['n']}: kernel {v['ms']:.4f} ms (profiler), "
                  f"call {v['call_ms']:.4f} ms (events), plain "
                  f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
                  f"({v['bound_by']})" + (
                      f", replaced path (fused kernel + matmul warp) "
                      f"{v['replaced_ms']:.4f} ms" if "replaced_ms" in v
                      else "") for k, v in t.items()))

    # 4. engine, pipeline and policy: cuda against cpu
    state_dicts = {g.name: load_state_dict(MODELS / g.model) for g in GAMES}
    for g in GAMES:
        t0 = time.perf_counter()
        phase(4, "engine", t0, engine_phase(g) + "; "
              + pipeline_phase(g, state_dicts[g.name]) + "; "
              + warp_pipeline_phase(g))

    # 5. serve: the main path of each game
    launches = {}
    for g in GAMES:
        t0 = time.perf_counter()
        mine, detail = serve_phase(g, state_dicts[g.name])
        launches.update(mine)
        phase(5, "serve", t0, detail)

    # 6. throughput
    for g in GAMES:
        t0 = time.perf_counter()
        phase(6, "throughput", t0, throughput_phase(
            g, state_dicts[g.name], timing[g.kernel + "_fused"]["ms"]))

    # 7. device profile of a short window of the serve and of throughput
    for g in GAMES:
        t0 = time.perf_counter()
        phase(7, "profile", t0, "; ".join(
            profile_phase(g, state_dicts[g.name], n, PROFILE_STEPS)
            for n in (SERVE_GAMES, THROUGHPUT_ENVS)))

    # 8. train: the slice's main path, Breakout at the recipe, and a
    # shorter update for the other two games (their warp kernels' path)
    for g in GAMES:
        t0 = time.perf_counter()
        full = g.name == "breakout"
        mine, detail, _ = train_phase(
            g, RECIPE["nsteps"] if full else TRAIN_SHORT_STEPS,
            TRAIN_UPDATES if full else 1)
        warp = g.kernel + "_fused_warp"
        launches[warp] = mine[warp]
        phase(8, "train", t0, detail)
    t0 = time.perf_counter()
    phase(8, "train profile", t0, train_profile_phase())

    # 9-11. the update on cuda against cpu, learning, the CLI
    t0 = time.perf_counter()
    phase(9, "update", t0, update_phase())
    t0 = time.perf_counter()
    phase(10, "identity", t0, identity_phase())
    t0 = time.perf_counter()
    phase(11, "cli", t0, cli_phase())

    kernels = []
    for g in GAMES:
        for name, line in zip((g.kernel, g.kernel + "_fused",
                               g.kernel + "_fused_warp"),
                              g.replaces + g.replaces[1:]):
            t = timing[name]
            kernels.append(dict(
                name=name, route="cuda",
                source=f"toybox_tpu_torch/csrc/{g.kernel}.cu",
                replaces=f"{PALLAS}:{line}", launches=launches[name],
                max_abs_err=err[name], ms=t["ms"], call_ms=t["call_ms"],
                plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

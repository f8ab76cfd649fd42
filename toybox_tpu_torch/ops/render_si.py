"""Space Invaders grey-frame rendering: the prep, the plain version and the
wrappers of the CUDA kernel ``csrc/si_frame.cu`` (port of the Space
Invaders part of toybox_tpu/ops/render_pallas.py:
``make_si_gray_renderer`` and ``make_si_gray_maxpool_renderer``).

``si_prep`` turns engine states into a 128-float table per env (layout in
the .cu file); ``render_frames`` composes u8[N, 210, 320] frames from it,
one frame or the max of two. For a CUDA tensor it launches the kernel
(``render_cuda.run_frame_kernel``); for a CPU tensor it runs
``frame_plain``, the plain PyTorch version of the same arithmetic.
"""

from __future__ import annotations

import torch

from toybox_tpu_torch.games import space_invaders as si
from toybox_tpu_torch.games.common import F32, packed_lumas
from toybox_tpu_torch.ops import obs
from toybox_tpu_torch.ops.render_cuda import max_of_frames, run_frame_kernel

H, W = si.HEIGHT, si.WIDTH
MAX_SHIELDS = 3
SHOW0 = 18 * MAX_SHIELDS                 # 54: formation show grid
ANCHOR = SHOW0 + si.N_ENEMIES            # 90: formation anchor (x, y)
SPRITE0 = ANCHOR + 2                     # 92: 7 sprites x (x, y, show)
N_SPRITES = 7                            # ufo, ship, ship laser, 4 lasers
PREP = 128                               # floats per frame (padded)
# sprite sizes in table order
_SPRITE_WH = ([(si.ENEMY_W, si.ENEMY_H), (si.SHIP_W, si.SHIP_H)]
              + [(si.LASER_W, si.LASER_H)] * (1 + si.MAX_ENEMY_LASERS))


def si_consts(config: si.Config) -> tuple:
    """The kernel's constants: the background, enemy, shield, UFO, ship and
    laser lumas (f32 values), the shield count, the shields' row y and 3
    shield xs. Like the TPU kernel's prep, it takes at most 3 shields on
    one row, inside the frame, and raises on anything else."""
    sp = config.shield_pos
    if len(sp) > MAX_SHIELDS:
        raise ValueError(f"the SI frame kernel draws at most {MAX_SHIELDS} "
                         f"shields, got {len(sp)}")
    if len({y for _, y in sp}) > 1:
        raise ValueError("the SI frame kernel needs all shields on one row")
    if not all(0 <= x <= W - si.SHIELD_W and 0 <= y <= H - si.SHIELD_H
               for x, y in sp):
        raise ValueError(f"a shield lies outside the frame: {sp}")
    lumas = packed_lumas([si.BG_COLOR, si.ENEMY_COLOR, si.SHIELD_COLOR,
                          si.UFO_COLOR, si.SHIP_COLOR, si.LASER_COLOR])
    xs = [float(x) for x, _ in sp] + [0.0] * (MAX_SHIELDS - len(sp))
    return lumas + (float(len(sp)), float(sp[0][1] if sp else 0), *xs)


def si_prep(s: si.State) -> torch.Tensor:
    """Engine states -> f32[N, PREP] kernel table (layout in the .cu file)."""
    n, n_sh = s.shield_alpha.shape[:2]
    dev = s.score.device
    bit = 1 << torch.arange(si.SHIELD_W, dtype=torch.int32, device=dev)
    rows = (s.shield_alpha.to(torch.int32) * bit).sum(-1).to(F32)  # [N,S,18]
    show = s.enemy_alive | (s.enemy_death_counter >= 0)
    anchor = torch.stack([s.enemy_x[:, 0], s.enemy_y[:, 0]], 1)
    sprites = torch.stack([
        s.ufo_x, s.ufo_y, (s.ufo_appearance_counter == 0).to(torch.int32),
        s.ship_x, s.ship_y,
        (s.ship_alive | (s.ship_death_counter >= 0)).to(torch.int32),
        s.ship_laser_x, s.ship_laser_y, s.ship_laser_alive.to(torch.int32),
    ] + [v for k in range(si.MAX_ENEMY_LASERS) for v in (
        s.elaser_x[:, k], s.elaser_y[:, k],
        s.elaser_alive[:, k].to(torch.int32))], 1)
    zeros = torch.zeros((n, PREP), dtype=F32, device=dev)
    return torch.cat([
        rows.reshape(n, -1), zeros[:, :18 * (MAX_SHIELDS - n_sh)],
        show.to(F32), anchor.to(F32), sprites.to(F32),
        zeros[:, :PREP - SPRITE0 - 3 * N_SPRITES]], 1)


def _frame_plain_one(p: torch.Tensor, consts) -> torch.Tensor:
    """f32[N, PREP] -> f32 luma frames [N, H, W] in [0, 255]."""
    bg, enemy, shield, ufo, ship, laser = consts[:6]
    n_sh, shield_y = int(consts[6]), int(consts[7])
    n, dev = p.shape[0], p.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    img = torch.full((n, H, W), bg, dtype=F32, device=dev)

    ai = p[:, ANCHOR:ANCHOR + 2].to(torch.int32)
    rx = xs - ai[:, 0, None, None]
    ry = ys - ai[:, 1, None, None]
    in_cell = ((rx >= 0) & (ry >= 0) & (rx < si.N_COLS * si.ENEMY_DX)
               & (ry < si.N_ROWS * si.ENEMY_DY)
               & (rx % si.ENEMY_DX < si.ENEMY_W)
               & (ry % si.ENEMY_DY < si.ENEMY_H))
    cell = ((ry // si.ENEMY_DY).clamp(0, si.N_ROWS - 1) * si.N_COLS
            + (rx // si.ENEMY_DX).clamp(0, si.N_COLS - 1))
    show = p[:, SHOW0:ANCHOR].gather(1, cell.reshape(n, -1)).view(cell.shape)
    img = torch.where(in_cell & (show > 0), enemy, img)

    # shields: the last shield that covers a pixel decides
    covered = torch.zeros((n, H, W), dtype=torch.bool, device=dev)
    bit = torch.arange(si.SHIELD_W, dtype=torch.int32, device=dev)
    for k in range(n_sh):
        x0 = int(consts[8 + k])
        rows = p[:, 18 * k:18 * (k + 1)].to(torch.int32)        # [N, 18]
        covered[:, shield_y:shield_y + si.SHIELD_H, x0:x0 + si.SHIELD_W] = (
            (rows[:, :, None] >> bit) & 1) > 0
    img = torch.where(covered, shield, img)

    fy, fx = ys.to(F32), xs.to(F32)
    sp = p[:, SPRITE0:SPRITE0 + 3 * N_SPRITES].reshape(n, N_SPRITES, 3)
    for k, (w, h) in enumerate(_SPRITE_WH):
        x0, y0, on = (sp[:, k, j, None, None] for j in range(3))
        m = (fx >= x0) & (fx < x0 + w) & (fy >= y0) & (fy < y0 + h) & (on > 0)
        img = torch.where(m, (ufo, ship)[k] if k < 2 else laser, img)
    return img.clamp(0.0, 255.0)


def frame_plain(prep: torch.Tensor, consts) -> torch.Tensor:
    """Plain PyTorch version of the Space Invaders kernel."""
    return max_of_frames(_frame_plain_one, prep, consts)


def frame_warp_plain(prep: torch.Tensor, consts,
                     tables: obs.WarpTables) -> torch.Tensor:
    """Plain PyTorch version of the Space Invaders kernel's warp form."""
    return obs.banded_warp(frame_plain(prep, consts), tables)


def render_frames(prep: torch.Tensor, consts,
                  tables: obs.WarpTables | None = None) -> torch.Tensor:
    """prep f32[N, F, PREP] (F = 1 one frame, F = 2 max of two frames) ->
    u8[N, H, W], or with warp ``tables`` (F = 2) -> u8[N, S, S]. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return run_frame_kernel("si_frame", prep, PREP, (H, W), consts,
                            frame_plain, tables)


def make_si_gray_renderer(config: si.Config):
    """fn(states) -> u8[N, 210, 320] grey frames."""
    consts = si_consts(config)

    def render(s: si.State) -> torch.Tensor:
        return render_frames(si_prep(s)[:, None], consts)

    return render


def make_si_gray_maxpool_renderer(config: si.Config,
                                  warp_to: int | None = None):
    """fn(states1, states2) -> u8[N, 210, 320], the max of the two frames
    composed in one kernel launch; with ``warp_to=84`` warped in the same
    launch -> u8[N, 84, 84]."""
    consts = si_consts(config)
    tables = (None if warp_to is None
              else obs.warp_tables(H, W, warp_to, config.device))

    def render2(s1: si.State, s2: si.State) -> torch.Tensor:
        return render_frames(torch.stack([si_prep(s1), si_prep(s2)], 1),
                             consts, tables)

    return render2

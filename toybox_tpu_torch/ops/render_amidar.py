"""Amidar grey-frame rendering: the prep, the plain version and the
wrappers of the CUDA kernel ``csrc/amidar_frame.cu`` (port of the Amidar
part of toybox_tpu/ops/render_pallas.py: ``make_amidar_gray_renderer`` and
``make_amidar_gray_maxpool_renderer``).

``amidar_prep`` turns engine states into a 1024-float table per env
(layout in the .cu file); ``render_frames`` composes u8[N, 250, 160]
frames from it, one frame or the max of two. For a CUDA tensor it launches
the kernel (``render_cuda.run_frame_kernel``); for a CPU tensor it runs
``frame_plain``, the plain PyTorch version of the same arithmetic.

The lumas are f32 values computed as ``luma2d`` computes them, so the
frames equal ``luma2d(amidar.render)`` exactly (the TPU kernel's prep forms
them in python doubles and may differ by one grey level).
"""

from __future__ import annotations

import torch

from toybox_tpu_torch.games import amidar as am
from toybox_tpu_torch.games.common import F32, packed_lumas
from toybox_tpu_torch.ops import obs
from toybox_tpu_torch.ops.render_cuda import max_of_frames, run_frame_kernel

H, W = am.HEIGHT, am.WIDTH
SPRITE0 = am.N_TILES                     # 992: 9 sprites x (x, y, show)
N_SPRITES = am.MAX_ENEMIES + 1           # 8 enemies, then the player
PREP = 1024                              # floats per frame (padded)


def amidar_consts(config: am.Config) -> tuple:
    """The kernel's constants: the lumas of tile codes 0..3 (background,
    inside a painted box, painted, unpainted), the enemies and the
    player, as python floats holding f32 values."""
    return packed_lumas([config.bg_color, config.inner_painted_color,
                         config.painted_color, config.unpainted_color,
                         config.enemy_color, config.player_color])


def amidar_prep(config: am.Config, s: am.State) -> torch.Tensor:
    """Engine states -> f32[N, PREP] kernel table (layout in the .cu file).
    The tile codes are those of ``amidar.render``: an empty tile inside a
    painted box (``box_painted @ inner_masks``) is code 1, painted 2, any
    other track tile 3."""
    n = s.score.shape[0]
    dev = s.score.device
    t = s.tiles
    code = torch.where(
        t == am.EMPTY, am.inner_painted(config, s).to(torch.int32),
        torch.where(t == am.PAINTED, 2, 3))

    def px(world, origin):
        return origin + world // am.WORLD_PER_PIXEL

    ones = torch.ones((n, 1), dtype=torch.bool, device=dev)
    sprites = torch.stack([
        torch.cat([px(s.enemy_x, am.BOARD_PX_X),
                   px(s.player_x, am.BOARD_PX_X)[:, None]], 1),
        torch.cat([px(s.enemy_y, am.BOARD_PX_Y),
                   px(s.player_y, am.BOARD_PX_Y)[:, None]], 1),
        torch.cat([s.enemy_exists, ones], 1).to(torch.int32),
    ], 2)                                      # [N, sprite, (x, y, show)]
    pad = torch.zeros((n, PREP - SPRITE0 - 3 * N_SPRITES), dtype=F32,
                      device=dev)
    return torch.cat([code.to(F32), sprites.reshape(n, -1).to(F32), pad], 1)


def _frame_plain_one(p: torch.Tensor, consts) -> torch.Tensor:
    """f32[N, PREP] -> f32 luma frames [N, H, W] in [0, 255]."""
    enemy, player = consts[4:6]
    n, dev = p.shape[0], p.device
    lut = torch.tensor(consts[:4], dtype=F32, device=dev)
    img = torch.full((n, H, W), consts[0], dtype=F32, device=dev)
    codes = p[:, :SPRITE0].to(torch.int32).clamp(0, 3).view(
        n, am.BOARD_H, am.BOARD_W)
    board = lut[codes.long()].repeat_interleave(am.TILE_PX_H, 1) \
        .repeat_interleave(am.TILE_PX_W, 2)
    img[:, am.BOARD_PX_Y:am.BOARD_PX_Y + am.BOARD_PX_H,
        am.BOARD_PX_X:am.BOARD_PX_X + am.BOARD_PX_W] = board

    fy = torch.arange(H, dtype=F32, device=dev)[:, None]
    fx = torch.arange(W, dtype=F32, device=dev)[None, :]
    sp = p[:, SPRITE0:SPRITE0 + 3 * N_SPRITES].reshape(n, N_SPRITES, 3)
    for k in range(N_SPRITES):
        x0, y0, on = (sp[:, k, j, None, None] for j in range(3))
        m = ((fx >= x0) & (fx < x0 + am.TILE_PX_W) & (fy >= y0)
             & (fy < y0 + am.TILE_PX_H) & (on > 0))
        img = torch.where(m, player if k == am.MAX_ENEMIES else enemy, img)
    return img.clamp(0.0, 255.0)


def frame_plain(prep: torch.Tensor, consts) -> torch.Tensor:
    """Plain PyTorch version of the Amidar kernel."""
    return max_of_frames(_frame_plain_one, prep, consts)


def frame_warp_plain(prep: torch.Tensor, consts,
                     tables: obs.WarpTables) -> torch.Tensor:
    """Plain PyTorch version of the Amidar kernel's warp form."""
    return obs.banded_warp(frame_plain(prep, consts), tables)


def render_frames(prep: torch.Tensor, consts,
                  tables: obs.WarpTables | None = None) -> torch.Tensor:
    """prep f32[N, F, PREP] (F = 1 one frame, F = 2 max of two frames) ->
    u8[N, H, W], or with warp ``tables`` (F = 2) -> u8[N, S, S]. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return run_frame_kernel("amidar_frame", prep, PREP, (H, W), consts,
                            frame_plain, tables)


def make_amidar_gray_renderer(config: am.Config):
    """fn(states) -> u8[N, 250, 160] grey frames."""
    consts = amidar_consts(config)

    def render(s: am.State) -> torch.Tensor:
        return render_frames(amidar_prep(config, s)[:, None], consts)

    return render


def make_amidar_gray_maxpool_renderer(config: am.Config,
                                      warp_to: int | None = None):
    """fn(states1, states2) -> u8[N, 250, 160], the max of the two frames
    composed in one kernel launch; with ``warp_to=84`` warped in the same
    launch -> u8[N, 84, 84]."""
    consts = amidar_consts(config)
    tables = (None if warp_to is None
              else obs.warp_tables(H, W, warp_to, config.device))

    def render2(s1: am.State, s2: am.State) -> torch.Tensor:
        return render_frames(torch.stack([amidar_prep(config, s1),
                                          amidar_prep(config, s2)], 1),
                             consts, tables)

    return render2

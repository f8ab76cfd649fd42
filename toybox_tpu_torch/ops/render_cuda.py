"""Breakout grey-frame rendering: the CUDA kernel, its plain version, the
wrapper and the build helper (port of the Breakout part of
toybox_tpu/ops/render_pallas.py).

``breakout_prep`` turns engine states into a small per-env table (brick
luma grid and sprite intervals, see ``csrc/breakout_frame.cu``).
``render_frames`` composes u8[N, 160, 240] frames from it: one frame, or
the max of two (the skip-4 max-pool). For a CUDA tensor it launches the
kernel in ``csrc/breakout_frame.cu``, built with ``nvcc`` at first use and
loaded with ``ctypes``; for a CPU tensor it runs ``frame_plain``, the plain
PyTorch version of the same arithmetic.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from toybox_tpu_torch.games import breakout as bk
from toybox_tpu_torch.games.common import F32, U8, luma

H, W = bk.HEIGHT, bk.WIDTH
GRID_ROWS, GRID_COLS = bk.MAX_RENDER_ROWS, bk.N_COLS
SPRITE0 = GRID_ROWS * GRID_COLS           # 432
N_SPRITES = 1 + bk.MAX_BALLS              # paddle + balls
PREP = 464                                # floats per frame (padded)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "breakout_frame.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# Kernel launches, counted by the wrapper (one per launch, nowhere else).
LAUNCHES = {"breakout_frame": 0, "breakout_frame_fused": 0}

_LIB = {}


# ---------------------------------------------------------------------------
# Prep (PyTorch, any device)
# ---------------------------------------------------------------------------

def _luma_u32(packed: torch.Tensor) -> torch.Tensor:
    """f32 luma of packed u32 RGBA colors (int64)."""
    return luma((packed & 0xFF).to(F32), ((packed >> 8) & 0xFF).to(F32),
                ((packed >> 16) & 0xFF).to(F32))


def breakout_lumas(config: bk.Config) -> tuple:
    """(background, wall, paddle, ball) lumas as python floats holding f32."""
    packed = torch.tensor([config.bg_color, config.frame_color,
                           config.paddle_color, config.ball_color])
    return tuple(float(v) for v in _luma_u32(packed))


def breakout_prep(s: bk.State) -> torch.Tensor:
    """Engine states -> f32[N, PREP] kernel table (layout in the .cu file).

    The paddle's y comes from ``state.paddle_y``, as ``breakout.render``
    draws it."""
    n = s.score.shape[0]
    dev = s.score.device
    rows = s.brick_row.long().clamp(0, GRID_ROWS - 1)
    cols = s.brick_col.long().clamp(0, GRID_COLS - 1)
    idx = rows * GRID_COLS + cols
    show = (s.brick_alive & s.brick_exists).to(F32)
    zeros = torch.zeros((n, SPRITE0), dtype=F32, device=dev)
    grid = zeros.scatter_add(1, idx, _luma_u32(s.brick_color) * show)
    occ = zeros.scatter_add(1, idx, show)
    grid = torch.where(occ > 0, grid, torch.full((), -1.0, device=dev))

    r = s.ball_radius[:, None]
    half = (s.paddle_width * 0.5)[:, None]
    px, py = s.paddle_x[:, None], s.paddle_y[:, None]
    showb = (s.ball_alive & ~s.reset[:, None]).to(F32)
    sprites = torch.stack([
        torch.cat([px - half, s.ball_x - r], 1),
        torch.cat([px + half, s.ball_x + r], 1),
        torch.cat([py, s.ball_y - r], 1),
        torch.cat([py + bk.PADDLE_HEIGHT, s.ball_y + r], 1),
        torch.cat([torch.ones_like(px), showb], 1),
    ], dim=2)                                        # [N, sprite, field]
    pad = torch.zeros((n, PREP - SPRITE0 - 5 * N_SPRITES), dtype=F32,
                      device=dev)
    return torch.cat([grid, sprites.reshape(n, 5 * N_SPRITES), pad], 1)


# ---------------------------------------------------------------------------
# Plain version (the kernel's arithmetic in PyTorch)
# ---------------------------------------------------------------------------

def _frame_plain_one(p: torch.Tensor, lumas) -> torch.Tensor:
    """f32[N, PREP] -> f32 luma frames [N, H, W] in [0, 255]."""
    bg, wall, pad, ball = lumas
    n, dev = p.shape[0], p.device
    ys = torch.arange(H, dtype=F32, device=dev)[:, None]
    xs = torch.arange(W, dtype=F32, device=dev)[None, :]
    walls = (ys >= 15) & ((xs < 12) | (xs >= 228) | (ys < 18))
    img = torch.where(walls, wall, bg).to(F32).expand(n, H, W)

    grid = p[:, :SPRITE0].reshape(n, GRID_ROWS, GRID_COLS)
    band = grid.repeat_interleave(bk.BRICK_CELL_H, 1).repeat_interleave(
        bk.BRICK_CELL_W, 2)
    cells = torch.full((n, H, W), -1.0, dtype=F32, device=dev)
    y0, x0 = bk.BRICK_BAND_Y0, 12
    cells[:, y0:y0 + band.shape[1], x0:x0 + band.shape[2]] = band
    img = torch.where(cells >= 0, cells, img)

    sp = p[:, SPRITE0:SPRITE0 + 5 * N_SPRITES].reshape(n, N_SPRITES, 5)
    sp = sp[:, :, :, None, None]
    cover = ((xs >= sp[:, :, 0]) & (xs < sp[:, :, 1]) & (ys >= sp[:, :, 2])
             & (ys < sp[:, :, 3]) & (sp[:, :, 4] > 0))  # [N, sprite, H, W]
    img = torch.where(cover[:, 0], pad, img)
    img = torch.where(cover[:, 1:].any(1), ball, img)
    return img.clamp(0.0, 255.0)


def frame_plain(prep: torch.Tensor, lumas) -> torch.Tensor:
    """Plain PyTorch version of the kernel: prep f32[N, F, PREP], F = 1
    (one frame) or 2 (max of two frames) -> u8[N, H, W]."""
    img = _frame_plain_one(prep[:, 0], lumas)
    if prep.shape[1] == 2:
        img = torch.maximum(img, _frame_plain_one(prep[:, 1], lumas))
    return img.to(torch.int32).to(U8)


# ---------------------------------------------------------------------------
# Build and launch
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build() -> tuple:
    """Compile the kernel with nvcc into BUILD_DIR (keyed by a hash of the
    source and flags) unless it is there. Returns (library path, compiler
    output, or "" when the library was already built)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"breakout_frame-{key[:16]}.so"
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    if "lib" not in _LIB:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.breakout_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        lib.breakout_frame.restype = ctypes.c_int
        _LIB["lib"] = lib
    return _LIB["lib"]


def render_frames(prep: torch.Tensor, lumas) -> torch.Tensor:
    """prep f32[N, F, PREP] (F = 1 one frame, F = 2 max of two frames)
    -> u8[N, H, W]. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if prep.dim() != 3 or prep.shape[1] not in (1, 2) \
            or prep.shape[2] != PREP:
        raise ValueError(f"prep must be [N, 1|2, {PREP}], got "
                         f"{tuple(prep.shape)}")
    if prep.dtype != F32:
        raise TypeError(f"prep must be float32, got {prep.dtype}")
    if prep.device.type == "cpu":
        return frame_plain(prep, lumas)
    if prep.device.type != "cuda":
        raise ValueError(f"unsupported device {prep.device}")
    if not prep.is_contiguous():
        raise ValueError("prep must be contiguous")
    fused = prep.shape[1] == 2
    n = prep.shape[0]
    out = torch.empty((n, H, W), dtype=U8, device=prep.device)
    lib = load_library()
    stream = torch.cuda.current_stream(prep.device).cuda_stream
    rc = lib.breakout_frame(prep.data_ptr(), out.data_ptr(), n, int(fused),
                            *lumas, prep.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"breakout_frame launch failed: CUDA error {rc}")
    LAUNCHES["breakout_frame_fused" if fused else "breakout_frame"] += 1
    return out


def make_breakout_gray_renderer(config: bk.Config):
    """fn(states) -> u8[N, 160, 240] grey frames."""
    lumas = breakout_lumas(config)

    def render(s: bk.State) -> torch.Tensor:
        return render_frames(breakout_prep(s)[:, None], lumas)

    return render


def make_breakout_gray_maxpool_renderer(config: bk.Config):
    """fn(states1, states2) -> u8[N, 160, 240], the max of the two frames
    composed in one kernel launch."""
    lumas = breakout_lumas(config)

    def render2(s1: bk.State, s2: bk.State) -> torch.Tensor:
        return render_frames(
            torch.stack([breakout_prep(s1), breakout_prep(s2)], 1), lumas)

    return render2

"""Frame kernels: the build and launch helpers shared by every CUDA source
in ``csrc/``, and the Breakout grey frame (port of the Breakout part of
toybox_tpu/ops/render_pallas.py; Space Invaders is in ``render_si.py``,
Amidar in ``render_amidar.py``).

Each frame kernel composes u8[N, H, W] grey frames from a small f32
per-env table (the prep), one frame or the max of two (the skip-4
max-pool), or, through its second entry point ``<name>_warp``, the max of
two warped to u8[N, S, S] in the same launch (``warp_to``, the warp in
``csrc/warp84.cuh``). For a CUDA tensor ``run_frame_kernel`` launches the
kernel, built with ``nvcc`` at first use and loaded with ``ctypes``; for a
CPU tensor it runs the game's plain PyTorch version of the same
arithmetic.

``breakout_prep`` turns Breakout states into their table (brick luma grid
and sprite intervals, see ``csrc/breakout_frame.cu``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from toybox_tpu_torch.games import breakout as bk
from toybox_tpu_torch.games.common import F32, U8, luma_packed, packed_lumas
from toybox_tpu_torch.ops import obs

H, W = bk.HEIGHT, bk.WIDTH
GRID_ROWS, GRID_COLS = bk.MAX_RENDER_ROWS, bk.N_COLS
SPRITE0 = GRID_ROWS * GRID_COLS           # 432
N_SPRITES = 1 + bk.MAX_BALLS              # paddle + balls
PREP = 464                                # floats per frame (padded)
CPU_BLOCK = 32                            # envs a plain version takes at once

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# Kernel launches, counted by the wrapper (one per launch, nowhere else).
LAUNCHES = {f"{k}{v}": 0 for k in ("breakout_frame", "si_frame",
                                   "amidar_frame")
            for v in ("", "_fused", "_fused_warp")}

_KERNELS = {}


# ---------------------------------------------------------------------------
# Prep (PyTorch, any device)
# ---------------------------------------------------------------------------

def breakout_lumas(config: bk.Config) -> tuple:
    """(background, wall, paddle, ball) lumas as python floats holding f32."""
    return packed_lumas([config.bg_color, config.frame_color,
                         config.paddle_color, config.ball_color])


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
    grid = zeros.scatter_add(1, idx, luma_packed(s.brick_color) * show)
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
    img = torch.where(walls, wall, bg).to(F32).expand(n, H, W).clone()

    grid = p[:, :SPRITE0].reshape(n, GRID_ROWS, GRID_COLS)
    band = grid.repeat_interleave(bk.BRICK_CELL_H, 1).repeat_interleave(
        bk.BRICK_CELL_W, 2)
    y0, x0 = bk.BRICK_BAND_Y0, 12
    cells = img[:, y0:y0 + band.shape[1], x0:x0 + band.shape[2]]
    cells.copy_(torch.where(band >= 0, band, cells))   # -1: no brick

    sp = p[:, SPRITE0:SPRITE0 + 5 * N_SPRITES].reshape(n, N_SPRITES, 5)
    sp = sp[:, :, :, None, None]
    # a sprite covers the pixels in both its row and its column interval:
    # the outer product of the two 0/1 masks (u8: a product is faster than
    # a broadcast bool and), one [H, W] mask at a time
    in_cols = ((xs >= sp[:, :, 0]) & (xs < sp[:, :, 1])).to(U8)  # [N, s, 1, W]
    in_rows = ((ys >= sp[:, :, 2]) & (ys < sp[:, :, 3])
               & (sp[:, :, 4] > 0)).to(U8)                      # [N, s, H, 1]
    img = torch.where((in_rows[:, 0] * in_cols[:, 0]).bool(), pad, img)
    balls = in_rows[:, 1] * in_cols[:, 1]
    for i in range(2, N_SPRITES):
        balls |= in_rows[:, i] * in_cols[:, i]
    img = torch.where(balls.bool(), ball, img)
    return img.clamp(0.0, 255.0)


def max_of_frames(one_frame, prep: torch.Tensor, consts) -> torch.Tensor:
    """A frame kernel's plain version from its one-frame form
    ``one_frame(f32[N, P], consts) -> f32[N, H, W]``: prep f32[N, F, P],
    F = 1 (one frame) or 2 (max of two frames) -> u8[N, H, W]. The max
    comes before the truncation, as in the kernels (truncation is
    monotone, so it equals the max of the truncated frames)."""
    img = one_frame(prep[:, 0], consts)
    if prep.shape[1] == 2:
        img = torch.maximum(img, one_frame(prep[:, 1], consts))
    return img.to(torch.int32).to(U8)


def frame_plain(prep: torch.Tensor, lumas) -> torch.Tensor:
    """Plain PyTorch version of the Breakout kernel."""
    return max_of_frames(_frame_plain_one, prep, lumas)


def frame_warp_plain(prep: torch.Tensor, lumas,
                     tables: obs.WarpTables) -> torch.Tensor:
    """Plain PyTorch version of the Breakout kernel's warp form."""
    return obs.banded_warp(frame_plain(prep, lumas), tables)


# ---------------------------------------------------------------------------
# Build and launch (every frame kernel)
# ---------------------------------------------------------------------------

def _nvcc() -> list:
    """The compiler's command (a list, so that a test can put a stand-in
    behind an interpreter)."""
    found = shutil.which("nvcc")
    if found:
        return [found]
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return [default]
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(src: Path) -> list:
    """``src`` and every file it includes with quotes, recursively (each
    once, relative to the including file, in the order first met)."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m for m in _INCLUDE.findall(path.read_text())]
    return seen


def _library_path(src: Path) -> Path:
    """The library of ``src``, keyed by its source, the headers it
    includes and the flags."""
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every ``csrc/*.cu`` into BUILD_DIR (keyed by a hash of its
    source and the flags) unless it is there, one nvcc per source, all
    started together. Returns {kernel name: (library path, compiler
    output, or "" when the library was already built)}."""
    built, running = {}, {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = _library_path(src)
        if lib.exists():
            built[src.stem] = (lib, "")
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        proc = subprocess.Popen([*_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[src.stem] = (src, lib, tmp, proc)
    failed = []
    for name, (src, lib, tmp, proc) in running.items():
        out, err = proc.communicate()
        try:
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n"
                              f"{out}{err}")
            else:
                os.replace(tmp, lib)
                built[name] = (lib, out + err)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


_P, _I = ctypes.c_void_p, ctypes.c_int
# (prep, out, n, fused, consts, n_consts, device, stream)
_FRAME_ARGS = [_P, _P, _I, _I, _P, _I, _I, _P]
# (prep, out, n, consts, n_consts, wy, wx, taps, size, device, stream)
_WARP_ARGS = [_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P]


def load_library(name: str, warp: bool = False):
    """A C entry point of kernel ``name`` (``csrc/<name>.cu``), building
    every kernel at first use: ``name`` (frames) or ``name``_warp (warped
    fused frames). Every library has both, with the signatures of
    _FRAME_ARGS and _WARP_ARGS; each returns a CUDA error code."""
    symbol = name + ("_warp" if warp else "")
    if symbol not in _KERNELS:
        path, _ = build()[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = _WARP_ARGS if warp else _FRAME_ARGS
        fn.restype = ctypes.c_int
        _KERNELS[symbol] = fn
    return _KERNELS[symbol]


def _check_tables(name: str, tables: obs.WarpTables, hw: tuple,
                  device) -> None:
    s = tables.size
    want = {"wy": ((s, hw[0]), F32), "wx": ((s, hw[1]), F32),
            "taps": ((2, s, 2), torch.int32)}
    for field, (shape, dtype) in want.items():
        t = getattr(tables, field)
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: warp table {field} must be a "
                             f"contiguous {dtype} {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def run_frame_kernel(name: str, prep: torch.Tensor, prep_len: int,
                     hw: tuple, consts, plain,
                     tables: obs.WarpTables | None = None) -> torch.Tensor:
    """prep f32[N, F, prep_len] (F = 1 one frame, F = 2 max of two frames)
    -> u8[N, *hw]; with warp ``tables`` (F = 2 only) the max of two frames
    warped in the same launch -> u8[N, S, S]. CPU tensors take the plain
    version, ``plain(prep, consts)`` (then ``obs.banded_warp``); CUDA
    tensors launch kernel ``name`` (or ``name``_warp) or raise.
    ``consts`` are the kernel's python float constants (lumas,
    geometry)."""
    if prep.dim() != 3 or prep.shape[1] not in (1, 2) \
            or prep.shape[2] != prep_len:
        raise ValueError(f"{name}: prep must be [N, 1|2, {prep_len}], got "
                         f"{tuple(prep.shape)}")
    if prep.dtype != F32:
        raise TypeError(f"{name}: prep must be float32, got {prep.dtype}")
    fused = prep.shape[1] == 2
    if tables is not None:
        if not fused:
            raise ValueError(f"{name}: the warp form takes two frames")
        _check_tables(name, tables, hw, prep.device)
    if prep.device.type == "cpu":
        # a block of envs at a time (each env's frame is its own): a
        # block's full-size intermediates stay in the cache
        return torch.cat([
            plain(p, consts) if tables is None
            else obs.banded_warp(plain(p, consts), tables)
            for p in prep.split(CPU_BLOCK)])
    if prep.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {prep.device}")
    if not prep.is_contiguous():
        raise ValueError(f"{name}: prep must be contiguous")
    n = prep.shape[0]
    host = (ctypes.c_float * len(consts))(*consts)
    stream = torch.cuda.current_stream(prep.device).cuda_stream
    if tables is None:
        out = torch.empty((n,) + tuple(hw), dtype=U8, device=prep.device)
        rc = load_library(name)(prep.data_ptr(), out.data_ptr(), n,
                                int(fused), host, len(consts),
                                prep.device.index, stream)
        key = name + ("_fused" if fused else "")
    else:
        s = tables.size
        out = torch.empty((n, s, s), dtype=U8, device=prep.device)
        rc = load_library(name, warp=True)(
            prep.data_ptr(), out.data_ptr(), n, host, len(consts),
            tables.wy.data_ptr(), tables.wx.data_ptr(),
            tables.taps.data_ptr(), s, prep.device.index, stream)
        key = name + "_fused_warp"
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return out


def render_frames(prep: torch.Tensor, lumas,
                  tables: obs.WarpTables | None = None) -> torch.Tensor:
    """Breakout: prep f32[N, F, PREP] -> u8[N, H, W], or with warp
    ``tables`` f32[N, 2, PREP] -> u8[N, S, S]."""
    return run_frame_kernel("breakout_frame", prep, PREP, (H, W), lumas,
                            frame_plain, tables)


def make_breakout_gray_renderer(config: bk.Config):
    """fn(states) -> u8[N, 160, 240] grey frames."""
    lumas = breakout_lumas(config)

    def render(s: bk.State) -> torch.Tensor:
        return render_frames(breakout_prep(s)[:, None], lumas)

    return render


def make_breakout_gray_maxpool_renderer(config: bk.Config,
                                        warp_to: int | None = None):
    """fn(states1, states2) -> u8[N, 160, 240], the max of the two frames
    composed in one kernel launch; with ``warp_to=84`` warped in the same
    launch -> u8[N, 84, 84]."""
    lumas = breakout_lumas(config)
    tables = (None if warp_to is None
              else obs.warp_tables(H, W, warp_to, config.device))

    def render2(s1: bk.State, s2: bk.State) -> torch.Tensor:
        return render_frames(
            torch.stack([breakout_prep(s1), breakout_prep(s2)], 1), lumas,
            tables)

    return render2

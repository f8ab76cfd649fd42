"""Shared raster helpers for game engines (port of
toybox_tpu.games.common: masks, painting, grey conversion), and
packed-RGBA colors: u32 ``r | g << 8 | b << 16 | a << 24`` held in python
ints or int64 tensors."""

from __future__ import annotations

import numpy as np
import torch

from toybox_tpu_torch.core import rng

F32 = torch.float32
U8 = torch.uint8

# f32 luma weights, rounded once as the JAX package rounds them
_LUMA_W = (0.299, 0.587, 0.114)


def rect_mask(h: int, w: int, x0, y0, x1, y1, device=None) -> torch.Tensor:
    """Boolean [..., h, w] mask of pixels with x in [x0, x1) and y in [y0, y1).

    Bounds are python floats or f32 tensors of shape [...]; pixel
    coordinates are the integer pixel indices as f32."""
    ys = torch.arange(h, dtype=F32, device=device)[:, None]
    xs = torch.arange(w, dtype=F32, device=device)[None, :]

    def b(v):
        return v[..., None, None] if torch.is_tensor(v) else v

    return (xs >= b(x0)) & (xs < b(x1)) & (ys >= b(y0)) & (ys < b(y1))


def paint(img: torch.Tensor, mask: torch.Tensor, color) -> torch.Tensor:
    """Overwrite masked pixels with an RGBA color. img u8[H, W, 4]."""
    color = torch.as_tensor(color, dtype=U8, device=img.device)
    return torch.where(mask[..., None], color, img)


def paint_rects(img: torch.Tensor, xywh, colors, alive) -> torch.Tensor:
    """Rasterize N axis-aligned rects (top-left x, y and w, h as floats)
    in order, later rects over earlier ones; rect i only where alive[i]."""
    h, w = img.shape[:2]
    dev = img.device
    xywh = torch.as_tensor(xywh, dtype=F32, device=dev)
    colors = torch.as_tensor(colors, dtype=U8, device=dev)
    alive = torch.as_tensor(alive, dtype=torch.bool, device=dev)
    for box, color, ok in zip(xywh, colors, alive):
        m = rect_mask(h, w, box[0], box[1], box[0] + box[2],
                      box[1] + box[3], device=dev) & ok
        img = paint(img, m, color)
    return img


def circle_mask(h: int, w: int, cx, cy, r, device=None) -> torch.Tensor:
    """Boolean [h, w] mask of the pixels whose centres lie within r of
    (cx, cy)."""
    ys = torch.arange(h, dtype=F32, device=device)[:, None] + 0.5
    xs = torch.arange(w, dtype=F32, device=device)[None, :] + 0.5
    return (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r


def to_grayscale(rgba: torch.Tensor) -> torch.Tensor:
    """RGBA u8 [..., H, W, 4] -> grayscale u8 [..., H, W, 1]."""
    return luma2d(rgba)[..., None]


def luma(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 luma of f32 channel values, as ``0.299 r + 0.587 g + 0.114 b``."""
    return (_LUMA_W[0] * r + _LUMA_W[1] * g) + _LUMA_W[2] * b


def luma2d(rgba: torch.Tensor) -> torch.Tensor:
    """RGBA uint8 [..., H, W, 4] -> grayscale uint8 [..., H, W]."""
    f = rgba[..., :3].to(F32)
    g = luma(f[..., 0], f[..., 1], f[..., 2])
    return g.clamp(0, 255).to(torch.int32).to(U8)


def pack_color(c) -> int:
    """RGBA u8[4] -> packed u32 (r | g<<8 | b<<16 | a<<24) as a python int."""
    c = [int(v) for v in np.asarray(c)]
    return c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24)


def unpack_color(p: torch.Tensor) -> torch.Tensor:
    """packed u32 (int64) [...] -> u8[..., 4]."""
    return torch.stack([(p >> s) & 0xFF for s in (0, 8, 16, 24)],
                       dim=-1).to(U8)


def luma_packed(packed: torch.Tensor) -> torch.Tensor:
    """f32 luma of packed u32 RGBA colors (int64 tensor), as ``luma2d``
    computes it from the unpacked channels."""
    return luma((packed & 0xFF).to(F32), ((packed >> 8) & 0xFF).to(F32),
                ((packed >> 16) & 0xFF).to(F32))


def packed_lumas(colors) -> tuple:
    """f32 lumas of packed colors (python ints), as python floats."""
    return tuple(float(v) for v in luma_packed(torch.tensor(list(colors))))


def start_keys(config, seeds) -> torch.Tensor:
    """Engine rng states int64[N, 4] for new games: from u32 ``seeds`` [N],
    or, when ``seeds`` is None, one game from the config's own rng words
    (``config.rand``, as the JAX ``new_game(config)`` takes them)."""
    if seeds is None:
        return torch.tensor([list(config.rand)], dtype=torch.int64,
                            device=config.device)
    return rng.seed(torch.as_tensor(seeds, device=config.device))


def rand_words(d: dict) -> tuple:
    """The config JSON's ``rand`` pair as four u32 words (python ints)."""
    return tuple(int(w) for w in rng.from_u64_pair(d["rand"]["state"]))

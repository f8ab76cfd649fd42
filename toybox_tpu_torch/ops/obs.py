"""Observation pipeline ops (port of toybox_tpu.ops.obs ``clip_reward`` and
of the bilinear warp in toybox_tpu/ops/render_pallas.py, which was an XLA
matmul in the JAX package and is a plain ``torch.matmul`` here)."""

from __future__ import annotations

import numpy as np
import torch

OBS_SIZE = 84


def bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """W [out, in] reproducing jax.image.resize(..., 'bilinear'): a
    half-pixel-centers triangle filter, widened by the scale factor when
    downsampling (antialiasing), rows normalized to 1."""
    w = np.zeros((out_size, in_size), np.float64)
    scale = out_size / in_size
    kernel_scale = min(scale, 1.0)
    i = np.arange(in_size)
    for o in range(out_size):
        src = (o + 0.5) / scale - 0.5
        weights = np.maximum(0.0, 1.0 - np.abs((i - src) * kernel_scale))
        total = weights.sum()
        if total > 0:
            w[o] = weights / total
    return w.astype(np.float32)


def make_warp(h: int, w: int, size: int = OBS_SIZE, device="cuda"):
    """fn(u8[..., h, w]) -> u8[..., size, size]: out = Wy @ img @ Wx^T in
    f32, rounded half to even and clipped, as the JAX ``warp_matmul``."""
    wy = torch.as_tensor(bilinear_matrix(size, h), device=device)
    wxt = torch.as_tensor(bilinear_matrix(size, w).T.copy(), device=device)

    def warp(frames: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(torch.matmul(wy, frames.to(torch.float32)), wxt)
        return out.round().clamp(0, 255).to(torch.uint8)

    return warp


def clip_reward(r: torch.Tensor) -> torch.Tensor:
    """Sign-clip rewards (ClipRewardEnv)."""
    return torch.sign(r.to(torch.float32))

"""Observation pipeline ops (port of toybox_tpu.ops.obs: ``warp_frame``,
``warp_frame2d``, ``max_pool_pair``, ``clip_reward``, ``push_frame_stack``
and ``reset_frame_stack``, batched tensor transforms of uint8
[..., H, W, C] frames; and of the bilinear warp in
toybox_tpu/ops/render_pallas.py).

The out-of-kernel warp (``make_warp``) was an XLA matmul in the JAX package
and is a plain ``torch.matmul`` here. The in-kernel warp of the fused frame
kernels (``warp_to=84``) takes the same weights as ``WarpTables`` with each
output row's tap range, and ``banded_warp`` is its plain version: the
contraction summed over the band only, in increasing index order.
"""

from __future__ import annotations

import dataclasses

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


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """f32 [..., H, W] -> u8 [..., size, size]: Wy @ x @ Wx^T with the
    ``bilinear_matrix`` weights, rounded half to even and clipped."""
    h, w = x.shape[-2:]
    wy = torch.as_tensor(bilinear_matrix(size, h), device=x.device)
    wxt = torch.as_tensor(bilinear_matrix(size, w).T.copy(), device=x.device)
    out = torch.matmul(torch.matmul(wy, x), wxt)
    return out.round().clamp(0, 255).to(torch.uint8)


def warp_frame(obs: torch.Tensor, size: int = OBS_SIZE) -> torch.Tensor:
    """Resize uint8 [..., H, W, C] to [..., size, size, C] (bilinear, as
    jax.image.resize: antialiased when shrinking). The engines render
    grey frames already, so there is no RGB-to-grey step."""
    x = obs.to(torch.float32).movedim(-1, -3)
    return _resize(x, size).movedim(-3, -1)


def warp_frame2d(obs: torch.Tensor, size: int = OBS_SIZE) -> torch.Tensor:
    """Channel-free warp: uint8 [..., H, W] -> [..., size, size]."""
    return _resize(obs.to(torch.float32), size)


def max_pool_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Max over the last two skipped frames (MaxAndSkipEnv)."""
    return torch.maximum(a, b)


def push_frame_stack(stack: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """FrameStack: stack [..., H, W, C*k]; frame [..., H, W, C] appended
    last, the oldest C channels dropped."""
    c = frame.shape[-1]
    return torch.cat([stack[..., c:], frame], dim=-1)


def reset_frame_stack(frame: torch.Tensor, k: int) -> torch.Tensor:
    """On reset the stack is the first frame repeated k times."""
    return torch.cat([frame] * k, dim=-1)


@dataclasses.dataclass(frozen=True)
class WarpTables:
    """The warp's weights on one device: wy f32[S, H], wx f32[S, W] (the
    ``bilinear_matrix`` values as they are) and taps i32[2, S, 2], the
    (first nonzero index, count) of each output row of wy (taps[0]) and of
    wx (taps[1]). Every weight is >= 0 and zero outside its band."""
    wy: torch.Tensor
    wx: torch.Tensor
    taps: torch.Tensor

    @property
    def size(self) -> int:
        return self.wy.shape[0]


def tap_ranges(w: np.ndarray) -> np.ndarray:
    """i32[S, 2]: each row's first nonzero column and the count up to and
    including its last nonzero column."""
    nz = w != 0
    first = nz.argmax(1)
    last = w.shape[1] - 1 - nz[:, ::-1].argmax(1)
    return np.stack([first, last - first + 1], 1).astype(np.int32)


def warp_tables(h: int, w: int, size: int = OBS_SIZE,
                device="cuda") -> WarpTables:
    wy, wx = bilinear_matrix(size, h), bilinear_matrix(size, w)
    taps = np.stack([tap_ranges(wy), tap_ranges(wx)])
    return WarpTables(wy=torch.as_tensor(wy, device=device),
                      wx=torch.as_tensor(wx, device=device),
                      taps=torch.as_tensor(taps, device=device))


def _band_sum(x: torch.Tensor, w: torch.Tensor, taps: torch.Tensor,
              dim: int) -> torch.Tensor:
    """out[..., o, ...] = sum over k of w[o, first_o + k] * x[..., first_o
    + k, ...] along ``dim`` (-2 or -1), one f32 multiply and one add per
    tap in increasing k. Past a row's count the weight is 0, and adding
    0 * x to a sum of non-negative finite terms leaves it unchanged, so
    every row gets exactly its band's sum."""
    first, count = taps[:, 0].long(), taps[:, 1].long()
    rows = torch.arange(w.shape[0], device=w.device)
    acc = None
    for k in range(int(count.max())):
        idx = (first + k).clamp(max=w.shape[1] - 1)
        wk = w[rows, idx] * (k < count)
        xk = x.index_select(dim, idx)
        term = (wk[:, None] if dim == -2 else wk) * xk
        acc = term if acc is None else acc + term
    return acc


def banded_warp(frames: torch.Tensor, tables: WarpTables) -> torch.Tensor:
    """u8[N, H, W] -> u8[N, S, S]: t = Wy·img, then out = t·Wxᵀ (the order
    of the JAX ``oh,hw,pw`` contraction), each a banded sum in f32, rounded
    half to even and clipped. The plain version of the in-kernel warp."""
    t = _band_sum(frames.to(torch.float32), tables.wy, tables.taps[0], -2)
    out = _band_sum(t, tables.wx, tables.taps[1], -1)
    return out.round().clamp(0, 255).to(torch.uint8)


def clip_reward(r: torch.Tensor) -> torch.Tensor:
    """Sign-clip rewards (ClipRewardEnv)."""
    return torch.sign(r.to(torch.float32))

"""Small shared utilities (port of toybox_tpu.utils.misc: the reference
baselines/common/__init__.py, math_util.py, tile_images.py), numpy only."""

from __future__ import annotations

import random

import numpy as np


def set_global_seeds(i: int) -> None:
    """Seed python/numpy RNGs (reference common/__init__.py; the port's
    torch draws come from explicit generators, so there is no torch
    global to seed)."""
    random.seed(i)
    np.random.seed(i)


def explained_variance(ypred, y):
    """1 - Var[y - ypred] / Var[y] (reference common/__init__.py)."""
    ypred = np.asarray(ypred).ravel()
    y = np.asarray(y).ravel()
    vary = np.var(y)
    return np.nan if vary == 0 else float(1 - np.var(y - ypred) / vary)


def discount(x, gamma):
    """Discounted cumulative sums along axis 0
    (reference common/math_util.py discount)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    acc = np.zeros_like(x[0])
    for t in reversed(range(len(x))):
        acc = x[t] + gamma * acc
        out[t] = acc
    return out


def tile_images(img_nhwc):
    """Tile a batch of images into one grid image
    (reference common/tile_images.py)."""
    img_nhwc = np.asarray(img_nhwc)
    n, h, w, c = img_nhwc.shape
    grid_w = int(np.ceil(np.sqrt(n)))
    grid_h = int(np.ceil(n / grid_w))
    pad = grid_h * grid_w - n
    imgs = np.concatenate(
        [img_nhwc, np.zeros((pad, h, w, c), img_nhwc.dtype)], axis=0)
    imgs = imgs.reshape(grid_h, grid_w, h, w, c)
    imgs = imgs.transpose(0, 2, 1, 3, 4)
    return imgs.reshape(grid_h * h, grid_w * w, c)

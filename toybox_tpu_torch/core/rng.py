"""Vectorizable xorshift128 RNG for game state (port of toybox_tpu.core.rng).

State layout: ``int64[..., 4]`` = ``[x, y, z, w]``, each word an unsigned
32-bit value held in an int64 and masked with ``& 0xFFFFFFFF``. torch's
uint32 has no ``>>``, ``%`` or ``>`` on the CPU, and an int32 ``>>`` is
arithmetic, so the words never live in a 32-bit dtype here. The JSON pair
is ``[x << 32 | y, z << 32 | w]``, as in the JAX package.

All draw functions are pure: ``(state) -> (new_state, value)`` over any
leading shape.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MASK32", "mul32", "seed", "next_u32", "uniform", "randint",
           "bernoulli", "to_u64_pair", "from_u64_pair"]

MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for u32 words ``a`` (int64) and a u32 constant.

    Split into 16-bit halves so that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seed(s: torch.Tensor) -> torch.Tensor:
    """Expand u32 seeds (int64 tensor of any shape) to rng state [..., 4]."""
    s = s.to(torch.int64) & MASK32
    words = []
    h = s
    for i in range(4):
        h = _mix32((h + ((_GOLDEN * (i + 1)) & MASK32)) & MASK32)
        words.append(h)
    st = torch.stack(words, dim=-1)
    zero = (st == 0).all(dim=-1, keepdim=True)
    return torch.where(zero, torch.full_like(st, 0xBAD5EED5), st)


def next_u32(state: torch.Tensor):
    """One xorshift128 step. state: int64[..., 4] -> (state', int64[...])."""
    x, y, z, w = state.unbind(-1)
    t = x ^ ((x << 11) & MASK32)
    t = t ^ (t >> 8)
    w_new = (w ^ (w >> 19)) ^ t
    return torch.stack([y, z, w, w_new], dim=-1), w_new


def uniform(state: torch.Tensor):
    """Draw float32 in [0, 1). One u32 consumed."""
    state, bits = next_u32(state)
    return state, (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def randint(state: torch.Tensor, n: int):
    """Draw int32 in [0, n)."""
    state, bits = next_u32(state)
    return state, (bits % n).to(torch.int32)


def bernoulli(state: torch.Tensor, p):
    """Draw bool u < p. One u32 consumed."""
    state, u = uniform(state)
    return state, u < torch.as_tensor(p, dtype=torch.float32,
                                      device=u.device)


def to_u64_pair(state) -> list:
    """u32[4] words -> [u64, u64] python ints for the reference JSON schema."""
    w = [int(v) & MASK32 for v in np.asarray(state).reshape(4)]
    return [(w[0] << 32) | w[1], (w[2] << 32) | w[3]]


def from_u64_pair(pair) -> np.ndarray:
    a, b = int(pair[0]), int(pair[1])
    return np.array([(a >> 32) & MASK32, a & MASK32,
                     (b >> 32) & MASK32, b & MASK32], dtype=np.int64)

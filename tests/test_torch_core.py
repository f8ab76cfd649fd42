"""The port's core modules against toybox_tpu.core: rng draw sequences and
the ALE action decode table are identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toybox_tpu.core import actions as jactions
from toybox_tpu.core import rng as jrng
from toybox_tpu_torch.core import actions as tactions
from toybox_tpu_torch.core import rng as trng


def _seeds(seed, n=64):
    r = np.random.default_rng(seed)
    s = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    s[:3] = [0, 1, 0xFFFFFFFF]
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_and_draw_sequences_match_jax(seed):
    s = _seeds(seed)
    jst = jrng.seed(jnp.asarray(s))
    tst = trng.seed(torch.as_tensor(s.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(jst).astype(np.int64),
                                  tst.numpy())
    for i in range(12):
        if i % 3 == 0:
            jst, jv = jrng.next_u32(jst)
            tst, tv = trng.next_u32(tst)
            np.testing.assert_array_equal(np.asarray(jv).astype(np.int64),
                                          tv.numpy())
        elif i % 3 == 1:
            jst, jv = jrng.uniform(jst)
            tst, tv = trng.uniform(tst)
            assert tv.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        else:
            n = 4 + i
            jst, jv = jrng.randint(jst, n)
            tst, tv = trng.randint(tst, n)
            assert tv.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jst).astype(np.int64),
                                  tst.numpy())


def test_mul32_wraps_like_u32():
    a = _seeds(5, 256).astype(np.uint64)
    for c in (2654435761, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 1):
        want = (a * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = trng.mul32(torch.as_tensor(a.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_u64_pair_round_trip_matches_jax():
    st = np.asarray(jrng.seed(jnp.uint32(99)))
    pair = jrng.to_u64_pair(st)
    assert trng.to_u64_pair(st.astype(np.int64)) == pair
    np.testing.assert_array_equal(trng.from_u64_pair(pair),
                                  jrng.from_u64_pair(pair).astype(np.int64))


def test_action_table_matches_jax():
    np.testing.assert_array_equal(tactions.ACTION_TABLE,
                                  np.asarray(jactions.ACTION_TABLE))
    assert tactions.LEGAL_ACTIONS == jactions.LEGAL_ACTIONS
    acts = np.arange(18)
    j = jactions.ale_to_input(jnp.asarray(acts))
    t = tactions.ale_to_input(torch.as_tensor(acts))
    for f in ("left", "right", "up", "down", "button1", "button2"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy())

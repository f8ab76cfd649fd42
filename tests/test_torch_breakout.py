"""The port's Breakout engine and batched env against the JAX package:
golden digests, the vmapped step leaf for leaf, and the auto-reset reseed."""

import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toybox_tpu.games.breakout as jbk
from toybox_tpu.core.actions import ale_to_input as j_ale_to_input
from toybox_tpu.envs.batched import make_batched_env as j_make_batched_env
from toybox_tpu_torch.core.actions import ale_to_input as t_ale_to_input
from toybox_tpu_torch.envs.batched import \
    make_batched_env as t_make_batched_env
from toybox_tpu_torch.games import breakout as tbk

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "breakout.json")


def _golden_script(legal, n):
    """The action script of tests/test_goldens.py."""
    acts = []
    for i in range(n):
        if i % 13 == 0:
            acts.append(1 if 1 in legal else legal[0])
        else:
            acts.append(legal[(i * 7 + i // 9) % len(legal)])
    return acts


def _digest(state_json) -> str:
    return hashlib.sha256(
        json.dumps(state_json, sort_keys=True).encode()).hexdigest()[:16]


def test_golden_digests_reproduce():
    expected = json.load(open(GOLDEN))
    cfg = tbk.default_config("cpu")
    s = tbk.new_game(cfg, torch.tensor([expected["seed"]]))
    digests = {}
    for i, a in enumerate(_golden_script(tbk.LEGAL_ACTIONS,
                                         expected["steps"])):
        s = tbk.step(cfg, s, t_ale_to_input(torch.tensor([a])))
        if (i + 1) % 50 == 0:
            digests[str(i + 1)] = _digest(tbk.state_to_json(cfg, s))
    assert digests == expected["digests"]
    assert int(s.score[0]) == expected["score"]
    assert int(s.lives[0]) == expected["lives"]


def _assert_states_equal(jstate, tstate, where=""):
    for f in tbk.FIELDS:
        j = np.asarray(getattr(jstate, f))
        t = getattr(tstate, f).cpu().numpy()
        if j.dtype == np.uint32:
            j = j.astype(np.int64)
        assert j.dtype == t.dtype, (f, j.dtype, t.dtype)
        np.testing.assert_array_equal(t, j, err_msg=f"{f} {where}")


def test_new_game_and_state_json_match_jax():
    seeds = np.array([0, 3, 1234, 0xFFFFFFFF], np.uint32)
    jcfg, tcfg = jbk.default_config(), tbk.default_config("cpu")
    js = jax.vmap(lambda s: jbk.new_game(jcfg, seed=s))(jnp.asarray(seeds))
    ts = tbk.new_game(tcfg, torch.as_tensor(seeds.astype(np.int64)))
    _assert_states_equal(js, ts)
    one = jax.tree_util.tree_map(lambda x: x[2], js)
    assert tbk.state_to_json(tcfg, ts, 2) == jbk.state_to_json(jcfg, one)


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_step_matches_vmapped_jax(seed):
    n, steps = 8, 100
    r = np.random.default_rng(seed)
    seeds = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    # FIRE often so balls are in play
    acts = r.choice(tbk.LEGAL_ACTIONS, size=(steps, n), p=[.2, .4, .2, .2])
    jcfg, tcfg = jbk.default_config(), tbk.default_config("cpu")
    js = jax.vmap(lambda s: jbk.new_game(jcfg, seed=s))(jnp.asarray(seeds))
    ts = tbk.new_game(tcfg, torch.as_tensor(seeds.astype(np.int64)))
    jstep = jax.jit(jax.vmap(jbk.step, in_axes=(None, 0, 0)))
    for i in range(steps):
        js = jstep(jcfg, js, j_ale_to_input(jnp.asarray(acts[i])))
        ts = tbk.step(tcfg, ts, t_ale_to_input(torch.as_tensor(acts[i])))
        _assert_states_equal(js, ts, f"step {i}")
    assert int(np.asarray(js.score).sum()) > 0


@pytest.mark.parametrize("fast", [False, True])
def test_auto_reset_reseed_matches_jax(fast):
    n, steps = 6, 400
    r = np.random.default_rng(3)
    acts = r.integers(0, 4, size=(steps, n))
    seeds = np.arange(n, dtype=np.uint32) + 7
    jenv = j_make_batched_env("breakout", n, obs_mode="none",
                              fast_auto_reset=fast)
    tenv = t_make_batched_env("breakout", n, obs_mode="none",
                              fast_auto_reset=fast, device="cpu")
    jst, _ = jenv.reset(jnp.asarray(seeds))
    tst, _ = tenv.reset(torch.as_tensor(seeds.astype(np.int64)))
    # one life left, so games end (and reset) inside the rollout
    jst = jst.replace(game=jst.game.replace(lives=jnp.ones(n, jnp.int32)))
    tst = dataclasses.replace(tst, game=tst.game.replace(
        lives=torch.ones(n, dtype=torch.int32)))
    jstep = jax.jit(jenv.step)
    n_done = 0
    for i in range(steps):
        jst, _, jr, jd, ji = jstep(jst, jnp.asarray(acts[i]))
        tst, _, tr, td, ti = tenv.step(tst, torch.as_tensor(acts[i]))
        _assert_states_equal(jst.game, tst.game, f"step {i}")
        np.testing.assert_array_equal(np.asarray(jst.seeds).astype(np.int64),
                                      tst.seeds.numpy())
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        for k in ("lives", "score", "episode_return", "episode_length"):
            np.testing.assert_array_equal(np.asarray(ji[k]), ti[k].numpy())
        for k in ("prev_score", "episode_return", "episode_length"):
            np.testing.assert_array_equal(np.asarray(getattr(jst, k)),
                                          getattr(tst, k).numpy())
        n_done += int(td.sum())
    assert n_done > 0

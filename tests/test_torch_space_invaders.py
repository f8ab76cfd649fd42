"""The port's Space Invaders engine and batched env against the JAX package:
golden digests (200-step and the seeded deep goldens: shield erosion, the
UFO kill), new_game and state_to_json, the vmapped step leaf for leaf, and
the auto-reset with and without the fast path (the game lists no
step-constant fields, so the fast path takes the full select)."""

import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toybox_tpu.games.space_invaders as jsi
from toybox_tpu.core.actions import ale_to_input as j_ale_to_input
from toybox_tpu.envs.batched import make_batched_env as j_make_batched_env
from toybox_tpu_torch.core.actions import ale_to_input as t_ale_to_input
from toybox_tpu_torch.envs.batched import \
    make_batched_env as t_make_batched_env
from toybox_tpu_torch.games import space_invaders as tsi

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# jitter 0.3 is not an f32 value: the enemy-fire draw compares in f32
VARIANT = dict(tsi._DEFAULT_CONFIG_JSON, jitter=0.3)


def _golden_script(legal, n):
    """The action script of tests/test_goldens.py."""
    return [(1 if 1 in legal else legal[0]) if i % 13 == 0
            else legal[(i * 7 + i // 9) % len(legal)] for i in range(n)]


def _digest(state_json) -> str:
    return hashlib.sha256(
        json.dumps(state_json, sort_keys=True).encode()).hexdigest()[:16]


def _play(seed, actions, every):
    cfg = tsi.default_config("cpu")
    s = tsi.new_game(cfg, torch.tensor([seed]))
    digests = {}
    for i, a in enumerate(actions):
        s = tsi.step(cfg, s, t_ale_to_input(torch.tensor([a])))
        if (i + 1) % every == 0:
            digests[str(i + 1)] = _digest(tsi.state_to_json(cfg, s))
    return digests, int(s.score[0]), int(s.lives[0])


def test_golden_digests_reproduce():
    g = json.load(open(os.path.join(GOLDENS, "space_invaders.json")))
    got = _play(g["seed"], _golden_script(tsi.LEGAL_ACTIONS, g["steps"]), 50)
    assert got == (g["digests"], g["score"], g["lives"])


@pytest.mark.parametrize("seed", [1234, 77, 9001])
def test_deep_golden_reproduces(seed):
    g = json.load(open(os.path.join(
        GOLDENS, f"space_invaders_deep_s{seed}.json")))
    assert "start_state" not in g
    got = _play(g["seed"], g["actions"], 250)
    assert got == (g["digests"], g["score"], g["lives"])


def _to_torch(js) -> tsi.State:
    out = {}
    for f in tsi.FIELDS:
        a = np.asarray(getattr(js, f))
        out[f] = torch.tensor(a.astype(np.int64) if a.dtype == np.uint32
                              else a)
    return tsi.State(**out)


def _assert_states_equal(jstate, tstate, where=""):
    for f in tsi.FIELDS:
        j = np.asarray(getattr(jstate, f))
        t = getattr(tstate, f).cpu().numpy()
        if j.dtype == np.uint32:
            j = j.astype(np.int64)
        assert j.dtype == t.dtype, (f, j.dtype, t.dtype)
        np.testing.assert_array_equal(t, j, err_msg=f"{f} {where}")


def test_new_game_and_state_json_match_jax():
    seeds = np.array([0, 3, 1234, 0xFFFFFFFF], np.uint32)
    jcfg, tcfg = jsi.default_config(), tsi.default_config("cpu")
    js = jax.vmap(lambda s: jsi.new_game(jcfg, seed=s))(jnp.asarray(seeds))
    ts = tsi.new_game(tcfg, torch.as_tensor(seeds.astype(np.int64)))
    _assert_states_equal(js, ts)
    one = jax.tree_util.tree_map(lambda x: x[2], js)
    assert tsi.state_to_json(tcfg, ts, 2) == jsi.state_to_json(jcfg, one)


@pytest.mark.parametrize("config_json", [tsi._DEFAULT_CONFIG_JSON, VARIANT],
                         ids=["default", "jitter0.3"])
def test_batched_step_matches_vmapped_jax(config_json):
    n, steps = 8, 300
    r = np.random.default_rng(0)
    seeds = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    acts = r.choice(tsi.LEGAL_ACTIONS, size=(steps, n))
    jcfg = jsi.config_from_json(config_json)
    tcfg = tsi.config_from_json(config_json, "cpu")
    js = jax.vmap(lambda s: jsi.new_game(jcfg, seed=s))(jnp.asarray(seeds))
    # skip the intro pause so the whole rollout is play
    js = js.replace(life_display_timer=jnp.ones(n, jnp.int32))
    ts = _to_torch(js)
    jstep = jax.jit(jax.vmap(jsi.step, in_axes=(None, 0, 0)))
    for i in range(steps):
        js = jstep(jcfg, js, j_ale_to_input(jnp.asarray(acts[i])))
        ts = tsi.step(tcfg, ts, t_ale_to_input(torch.as_tensor(acts[i])))
        _assert_states_equal(js, ts, f"step {i}")
    assert int(np.asarray(js.score).sum()) > 0
    assert not np.asarray(js.shield_alpha).all()       # shields eroded


@pytest.fixture(scope="module")
def jax_auto_reset_run():
    """A JAX batched-env rollout with one life left, so games end (and
    reset) inside it; fast_auto_reset changes nothing for this game."""
    n, steps = 6, 400
    r = np.random.default_rng(3)
    acts = r.integers(0, len(tsi.LEGAL_ACTIONS), size=(steps, n))
    seeds = np.arange(n, dtype=np.uint32) + 7
    env = j_make_batched_env("space_invaders", n, obs_mode="none",
                             fast_auto_reset=True)
    st, _ = env.reset(jnp.asarray(seeds))
    st = st.replace(game=st.game.replace(lives=jnp.ones(n, jnp.int32)))
    jstep = jax.jit(env.step)
    out = []
    for i in range(steps):
        st, _, rew, done, info = jstep(st, jnp.asarray(acts[i]))
        out.append(jax.device_get((st, rew, done, info)))
    return seeds, acts, out


@pytest.mark.parametrize("fast", [False, True])
def test_auto_reset_matches_jax(jax_auto_reset_run, fast):
    seeds, acts, jrun = jax_auto_reset_run
    n = len(seeds)
    tenv = t_make_batched_env("space_invaders", n, fast_auto_reset=fast,
                              device="cpu")
    tst, _ = tenv.reset(torch.as_tensor(seeds.astype(np.int64)))
    tst = dataclasses.replace(tst, game=tst.game.replace(
        lives=torch.ones(n, dtype=torch.int32)))
    n_done = 0
    for i, (jst, jr, jd, ji) in enumerate(jrun):
        tst, _, tr, td, ti = tenv.step(tst, torch.as_tensor(acts[i]))
        _assert_states_equal(jst.game, tst.game, f"step {i}")
        np.testing.assert_array_equal(np.asarray(jst.seeds).astype(np.int64),
                                      tst.seeds.numpy())
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        for k in ("lives", "score", "episode_return", "episode_length"):
            np.testing.assert_array_equal(np.asarray(ji[k]), ti[k].numpy())
        n_done += int(td.sum())
    assert n_done > 0

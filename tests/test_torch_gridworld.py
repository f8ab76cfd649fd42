"""The port's Gridworld engine against the JAX package: every case of
tests/test_gridworld.py on the port, the golden digests through the port's
facade, the vmapped step and ``render`` field for field on the default and
a non-default grid, and the JSON codecs. All exact."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toybox_tpu.games.gridworld as jgw
import toybox_tpu_torch
from tests.test_goldens import _action_script, _digest
from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.core.actions import ale_to_input as j_ale_to_input
from toybox_tpu_torch.core.actions import ale_to_input as t_ale_to_input
from toybox_tpu_torch.core.types import Input
from toybox_tpu_torch.games import gridworld as tgw

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "gridworld.json")

UP = Input(up=True)
DOWN = Input(down=True)
LEFT = Input(left=True)
RIGHT = Input(right=True)


def _color(r, g, b):
    return {"r": r, "g": g, "b": b, "a": 255}


# another size (11 x 5), a second reward tile and another player color
ALT_CONFIG = {
    "reward_becomes": "0",
    "grid": ["11111111111", "10R00S000G1", "10111011101", "1000S0R0001",
             "11111111111"],
    "player_start": [1, 3],
    "player_color": _color(0, 0, 255),
    "game_size": [11, 5],
    "tiles": {
        "0": {"color": _color(255, 255, 255), "goal": False, "reward": 0,
              "walkable": True},
        "1": {"color": _color(0, 0, 0), "goal": False, "reward": 0,
              "walkable": False},
        "G": {"color": _color(0, 255, 0), "goal": True, "reward": 10,
              "walkable": True},
        "R": {"color": _color(255, 255, 0), "goal": False, "reward": 1,
              "walkable": True},
        "S": {"color": _color(200, 0, 200), "goal": False, "reward": 3,
              "walkable": True},
    },
}
CONFIGS = {"default": jgw._DEFAULT_CONFIG_JSON, "alt": ALT_CONFIG}
# ALE actions from the start onto reward tiles (2 up, 3 right, 4 left)
SCRIPTS = {"default": (4, 2, 2, 2, 3, 3, 3), "alt": (2, 2, 3, 3, 3, 3)}


def _step(cfg, s, inp):
    return tgw.step(cfg, s, Input(**{
        k: torch.tensor([v]) for k, v in vars(inp).items()}))


def _player(s):
    return s.player[0].tolist()


# -- the cases of tests/test_gridworld.py ------------------------------------

def test_default_layout():
    cfg = tgw.default_config("cpu")
    st = tgw.new_game(cfg)
    assert tuple(st.grid.shape) == (1, 7, 9)
    assert _player(st) == [2, 4]
    assert int(st.score[0]) == 0 and not bool(st.game_over[0])


def test_wall_blocks():
    cfg = tgw.default_config("cpu")
    st = _step(cfg, tgw.new_game(cfg), LEFT)
    assert _player(st) == [1, 4]
    assert _player(_step(cfg, st, LEFT)) == [1, 4]   # col 0 is wall


def test_reward_consumed_once():
    cfg = tgw.default_config("cpu")
    st = tgw.new_game(cfg)
    for m in [LEFT, UP, UP, UP, RIGHT, RIGHT, RIGHT]:
        st = _step(cfg, st, m)
    assert _player(st) == [4, 1]
    assert int(st.score[0]) == 1            # collected the R tile
    st = _step(cfg, _step(cfg, st, LEFT), RIGHT)
    assert int(st.score[0]) == 1            # no double reward


def test_goal_ends_game():
    cfg = tgw.default_config("cpu")
    st = tgw.new_game(cfg)
    st = st.replace(player=torch.tensor([[6, 5]], dtype=torch.int32))
    assert bool(st.tile_walkable[0, int(st.grid[0, 5, 6])])
    st = _step(cfg, st, RIGHT)
    assert _player(st) == [7, 5]
    assert bool(st.game_over[0]) and int(st.score[0]) == 10
    assert int(st.lives[0]) == 0
    assert _player(_step(cfg, st, LEFT)) == [7, 5]   # frozen after it


def test_batch():
    cfg = tgw.default_config("cpu")
    n = 8
    st = tgw.new_game(cfg, torch.arange(n))
    left = torch.arange(n) % 2 == 1
    st2 = tgw.step(cfg, st, Input(left=left, right=~left))
    assert (st2.player[0::2] == torch.tensor([3, 4],
                                             dtype=torch.int32)).all()
    assert (st2.player[1::2] == torch.tensor([1, 4],
                                             dtype=torch.int32)).all()


def test_json_roundtrip():
    cfg = tgw.default_config("cpu")
    st = _step(cfg, tgw.new_game(cfg), LEFT)
    js = tgw.state_to_json(cfg, st)
    assert tgw.state_to_json(cfg, tgw.state_from_json(cfg, js)) == js
    cjs = tgw.config_to_json(cfg)
    assert tgw.config_to_json(tgw.config_from_json(cjs, "cpu")) == cjs


def test_render():
    cfg = tgw.default_config("cpu")
    img = tgw.render(cfg, tgw.new_game(cfg))[0].numpy()
    assert img.shape == (7 * tgw.TILE_PX, 9 * tgw.TILE_PX, 4)
    px, py = 2 * tgw.TILE_PX + 2, 4 * tgw.TILE_PX + 2
    assert img[py, px, 0] == 255 and img[py, px, 1] == 0   # player is red


# -- against the JAX package -------------------------------------------------

def test_golden_digests_reproduce_through_the_facade():
    """tests/goldens/gridworld.json with the action script of
    tests/test_goldens.py; ``set_seed`` leaves the rng-less config as it
    is, as the JAX facade does."""
    expected = json.load(open(GOLDEN))
    tb = toybox_tpu_torch.Toybox("gridworld", seed=expected["seed"],
                                 device="cpu")
    legal = tb.get_legal_action_set()
    digests = {}
    for i, a in enumerate(_action_script("gridworld", legal,
                                         expected["steps"])):
        tb.apply_ale_action(a)
        if (i + 1) % 50 == 0:
            digests[str(i + 1)] = _digest(tb.to_state_json())
    assert digests == expected["digests"]
    assert (tb.get_score(), tb.get_lives()) == (expected["score"],
                                                expected["lives"])


def _assert_states_equal(jstate, tstate, where=""):
    for f in tgw.FIELDS:
        j = np.asarray(getattr(jstate, f))
        t = getattr(tstate, f).cpu().numpy()
        if j.dtype == np.uint32:
            j = j.astype(np.int64)
        assert j.dtype == t.dtype, (f, j.dtype, t.dtype)
        np.testing.assert_array_equal(t, j, err_msg=f"{f} {where}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_and_render_match_vmapped_jax(name):
    """N = 8 envs, 200 random steps: every field after every step, and the
    RGBA frames every 10 steps, exactly equal. The non-default grid renders
    at its own size."""
    n, steps = 8, 200
    r = np.random.default_rng(4)
    seeds = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    acts = r.choice(tgw.LEGAL_ACTIONS, size=(steps, n))
    jcfg = jgw.config_from_json(CONFIGS[name])
    tcfg = tgw.config_from_json(CONFIGS[name], "cpu")
    js = jax.vmap(lambda s: jgw.new_game(jcfg, seed=s))(jnp.asarray(seeds))
    ts = tgw.new_game(tcfg, torch.as_tensor(seeds.astype(np.int64)))
    _assert_states_equal(js, ts, "at the start")
    jstep = jax.jit(jax.vmap(jgw.step, in_axes=(None, 0, 0)))
    jrender = jax.jit(jax.vmap(jgw.render, in_axes=(None, 0)))
    for i in range(steps):
        js = jstep(jcfg, js, j_ale_to_input(jnp.asarray(acts[i])))
        ts = tgw.step(tcfg, ts, t_ale_to_input(torch.as_tensor(acts[i])))
        _assert_states_equal(js, ts, f"step {i}")
        if i % 10 == 0 or i == steps - 1:
            np.testing.assert_array_equal(tgw.render(tcfg, ts).numpy(),
                                          np.asarray(jrender(jcfg, js)))
    h, w = np.asarray(jcfg.grid).shape
    assert tuple(tgw.render(tcfg, ts).shape) == (n, 16 * h, 16 * w, 4)
    assert int(ts.score.sum()) > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_codecs_match_jax(name):
    """config_to_json and state_to_json equal JAX's dicts (reward_becomes
    a char in the config, a code in the state); each *_from_json of JAX's
    JSON gives JAX's config and state."""
    jcfg = jgw.config_from_json(CONFIGS[name])
    tcfg = tgw.config_from_json(CONFIGS[name], "cpu")
    assert tgw.config_to_json(tcfg) == jgw.config_to_json(jcfg)
    assert tgw.config_from_json(jgw.config_to_json(jcfg),
                                "cpu").tile_chars == jcfg.tile_chars
    for f in ("grid", "player_start", "player_color", "tile_color",
              "tile_goal", "tile_reward", "tile_walkable"):
        np.testing.assert_array_equal(getattr(tcfg, f).numpy(),
                                      np.asarray(getattr(jcfg, f)), f)
    assert tcfg.reward_becomes == int(jcfg.reward_becomes)
    js, ts = jgw.new_game(jcfg), tgw.new_game(tcfg)
    for a in SCRIPTS[name]:                   # onto the reward tiles
        js = jgw.step(jcfg, js, j_ale_to_input(jnp.asarray(a)))
        ts = tgw.step(tcfg, ts, t_ale_to_input(torch.tensor([a])))
    assert int(ts.score[0]) > 0
    jjs = jgw.state_to_json(jcfg, js)
    assert tgw.state_to_json(tcfg, ts) == jjs
    _assert_states_equal(
        jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None],
                               jgw.state_from_json(jcfg, jjs)),
        tgw.state_from_json(tcfg, jjs))
    done = dict(jjs, game_over=True)
    assert int(tgw.state_from_json(tcfg, done).lives[0]) == 0

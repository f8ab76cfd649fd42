"""The port's state and config codecs against the JAX package's: the state
JSON of random play goes through the port's ``state_from_json`` and back
unchanged, and gives the same tensors as the JAX ``state_from_json``;
``config_to_json``, ``schema()`` and every native query agree with the
JAX package's, for the default config and for each behavioral scenario's
set-up (captured by the JAX package)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg  # noqa: F401  (loads the OpenBLAS that JAX's LAPACK uses)
import threadpoolctl
import torch

import toybox_tpu
from toybox_tpu.games import get_game as j_get_game
from toybox_tpu.sample_tests import get_scenarios as j_get_scenarios
from toybox_tpu.sample_tests.runner import capture_setup as j_capture_setup
from toybox_tpu_torch.games import get_game as t_get_game

# OpenBLAS on one thread for the rest of this test worker's life: a
# worker that forks (the vec-env executors' tests fork their workers)
# after its OpenBLAS thread pool has started leaves its later LAPACK calls
# (JAX's linear algebra on the CPU) waiting forever. The port's test files
# import this module.
threadpoolctl.threadpool_limits(1, user_api="blas")

GAMES = ("breakout", "space_invaders", "amidar")
QUERIES = {
    "breakout": [("bricks_remaining", None), ("channel_count", None)],
    "space_invaders": [("shield_cell_count", None),
                       ("enemies_remaining", None), ("ship_x", None)],
    "amidar": [("tile_to_world", {"tx": 3, "ty": 7}),
               ("world_to_tile", {"x": 200, "y": 333}),
               ("num_tiles_unpainted", None), ("regular_mode", None),
               ("jump_mode", None), ("chase_mode", None),
               ("jumps_remaining", None), ("num_enemies", None),
               ("enemy_tiles", None), ("enemy_tile", 0),
               ("enemy_caught", 0), ("player_tile", None)],
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The torch ops of these tests are small: one intra-op thread does
    them as fast and leaves the cores to the other test workers (the
    port's test files that compare with JAX import this fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_play_jsons(game, seed, marks=(0, 40, 250)):
    """State JSONs of the JAX facade after random play (FIRE every 7th
    frame), at each frame count in ``marks``."""
    r = np.random.default_rng(seed)
    tb = toybox_tpu.Toybox(game, seed=seed)
    legal = tb.get_legal_action_set()
    out = []
    for i in range(max(marks) + 1):
        if i in marks:
            out.append(tb.to_state_json())
        tb.apply_ale_action(1 if i % 7 == 0 else int(r.choice(legal)))
    return out


def jax_state_to_port(tmod, jstate, batched=False):
    """A JAX state (one env, or [N, ...] with ``batched``) as the port's
    [N, ...] state on the CPU (u32 fields as int64)."""
    out = {}
    for f in tmod.FIELDS:
        a = np.asarray(getattr(jstate, f))
        a = a.astype(np.int64) if a.dtype == np.uint32 else a
        out[f] = torch.tensor(a if batched else a[None])
    return tmod.State(**out)


def assert_fields_equal(tmod, jstate, tstate, batched=False, where=""):
    want = jax_state_to_port(tmod, jstate, batched)
    for f in tmod.FIELDS:
        got = getattr(tstate, f).cpu()
        exp = getattr(want, f)
        assert got.dtype == exp.dtype, (f, got.dtype, exp.dtype)
        assert torch.equal(got, exp), f"field {f} differs {where}"


def _setups(game):
    """(name, config JSON, state JSON): the default game and each
    scenario's set-up, captured by the JAX package."""
    jmod = j_get_game(game)
    js = jmod.state_to_json(jmod.default_config(),
                            jmod.new_game(jmod.default_config()))
    out = [("default", jmod.config_to_json(jmod.default_config()), js)]
    for cls in j_get_scenarios(game):
        out.append((cls.__name__,) + j_capture_setup(cls(seed=0)))
    return out


@pytest.mark.parametrize("game", GAMES)
@pytest.mark.parametrize("seed", [0, 77])
def test_state_json_round_trips_through_the_port(game, seed):
    jmod, tmod = j_get_game(game), t_get_game(game)
    jcfg, tcfg = jmod.default_config(), tmod.default_config("cpu")
    for k, js in enumerate(random_play_jsons(game, seed)):
        ts = tmod.state_from_json(tcfg, js)
        assert ts.score.shape == (1,)
        assert tmod.state_to_json(tcfg, ts, 0) == js, f"state {k}"
        assert_fields_equal(tmod, jmod.state_from_json(jcfg, js), ts,
                            where=f"in state {k}")


@pytest.mark.parametrize("game", GAMES)
def test_config_schema_and_queries_match_jax(game):
    jmod, tmod = j_get_game(game), t_get_game(game)
    assert tmod.schema() == jmod.schema()
    for name, cfg_js, st_js in _setups(game):
        jcfg = jmod.config_from_json(cfg_js)
        tcfg = tmod.config_from_json(cfg_js, "cpu")
        assert tmod.config_to_json(tcfg) == jmod.config_to_json(jcfg), name
        assert tmod.config_to_json(tcfg) == cfg_js, name
        jst = jmod.state_from_json(jcfg, st_js)
        tst = tmod.state_from_json(tcfg, st_js)
        assert tmod.state_to_json(tcfg, tst) == st_js, name
        assert_fields_equal(tmod, jst, tst, where=f"in {name}")
        for q, args in QUERIES[game]:
            assert (tmod.query(tcfg, tst, q, args)
                    == jmod.query(jcfg, jst, q, args)), (name, q)
        with pytest.raises(ValueError):
            tmod.query(tcfg, tst, "no_such_query")


@pytest.mark.parametrize("game", GAMES)
def test_new_game_from_config_rand_matches_jax(game):
    """``new_game(config)`` with no seeds draws from the config's own rng
    words, as the JAX ``new_game(config)`` does; a config read from JSON
    keeps them."""
    jmod, tmod = j_get_game(game), t_get_game(game)
    cfg_js = dict(jmod.config_to_json(jmod.default_config()),
                  rand={"state": [12345678901234567, 98765432109876543]})
    jcfg = jmod.config_from_json(cfg_js)
    tcfg = tmod.config_from_json(cfg_js, "cpu")
    ts = tmod.new_game(tcfg)
    assert ts.score.shape == (1,)
    assert_fields_equal(tmod, jmod.new_game(jcfg), ts)
    assert tmod.config_to_json(tcfg)["rand"] == cfg_js["rand"]


def test_breakout_serve_index_clamps_to_the_starts_it_has():
    """A config with fewer than four serve positions (PolarStarts) serves
    from the last one whenever the draw lands past it, as the JAX gather
    clamps."""
    jmod, tmod = j_get_game("breakout"), t_get_game("breakout")
    cfg_js = jmod.config_to_json(jmod.default_config())
    cfg_js["ball_start_positions"] = [
        {"x": 24.0, "y": 80.0, "angle_degrees": 30.0}]
    jcfg = jmod.config_from_json(cfg_js)
    tcfg = tmod.config_from_json(cfg_js, "cpu")
    seeds = np.arange(16, dtype=np.uint32)
    js = jax.vmap(lambda s: jmod.new_game(jcfg, seed=s))(jnp.asarray(seeds))
    ts = tmod.new_game(tcfg, torch.as_tensor(seeds.astype(np.int64)))
    assert_fields_equal(tmod, js, ts, batched=True)
    assert (ts.ball_x[:, 0] == 24.0).all()


def test_state_from_json_refuses_more_entities_than_it_holds():
    tmod = t_get_game("breakout")
    cfg = tmod.default_config("cpu")
    js = tmod.state_to_json(cfg, tmod.new_game(cfg))
    js["balls"] = js["balls"] * (tmod.MAX_BALLS + 1)
    with pytest.raises(ValueError, match="balls"):
        tmod.state_from_json(cfg, js)
    tmod = t_get_game("amidar")
    cfg = tmod.default_config("cpu")
    js = tmod.state_to_json(cfg, tmod.new_game(cfg))
    js["enemies"] = js["enemies"] * 2
    with pytest.raises(ValueError, match="enemies"):
        tmod.state_from_json(cfg, js)

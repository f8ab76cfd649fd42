"""The port's ``ctoybox`` facade against the JAX package's: the same seed
and action script give the same state JSON, frames (grey and RGBA),
score, lives, level and native queries; JSON written into one facade
reads back the same, in both packages; every game of the JAX package is
in the port's registry and an unknown game raises. Also the replay of the
deep goldens that start from a doctored state, which
tests/test_torch_deep_*.py run through the port's facade."""

import json
import os

import numpy as np
import pytest

import toybox_tpu
import toybox_tpu.games
import toybox_tpu_torch
from tests.test_goldens import _digest
from tests.test_torch_codecs import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CHECK_EVERY = 250      # as tests/test_goldens_deep.py
QUERIES = {"breakout": ("bricks_remaining", "channel_count"),
           "space_invaders": ("shield_cell_count", "enemies_remaining",
                              "ship_x"),
           "amidar": ("num_tiles_unpainted", "jumps_remaining",
                      "num_enemies", "enemy_tiles", "player_tile",
                      "regular_mode", "jump_mode", "chase_mode")}


def replay_deep_golden(name):
    """Replay a deep golden's start state and action script through the
    port's facade on the CPU; assert its digests, score and lives."""
    g = json.load(open(os.path.join(GOLDEN_DIR, f"{name}.json")))
    assert "start_state" in g and len(g["actions"]) >= 2050
    tb = toybox_tpu_torch.Toybox(g["game"], seed=g["seed"], device="cpu")
    tb.write_state_json(g["start_state"])
    assert tb.to_state_json() == g["start_state"]
    digests = {}
    for i, a in enumerate(g["actions"]):
        tb.apply_ale_action(a)
        if (i + 1) % CHECK_EVERY == 0:
            digests[str(i + 1)] = _digest(tb.to_state_json())
    assert digests == g["digests"]
    assert (tb.get_score(), tb.get_lives()) == (g["score"], g["lives"])


def _pair(game, seed, **kw):
    return (toybox_tpu.Toybox(game, seed=seed, **kw),
            toybox_tpu_torch.Toybox(game, seed=seed, device="cpu", **kw))


def _assert_same(jtb, ttb, where):
    assert ttb.to_state_json() == jtb.to_state_json(), where
    assert (ttb.get_score(), ttb.get_lives(), ttb.get_level()) == (
        jtb.get_score(), jtb.get_lives(), jtb.get_level()), where
    for q in QUERIES[jtb.game_name]:
        name = f"{jtb.game_name}_{q}"
        assert (getattr(ttb.rstate, name)()
                == getattr(jtb.rstate, name)()), (where, q)


@pytest.mark.parametrize("game,frameskip", [
    ("breakout", 0), ("space_invaders", 0), ("amidar", 0), ("amidar", 3)])
def test_facade_matches_jax(game, frameskip):
    jtb, ttb = _pair(game, 1234, frameskip=frameskip)
    assert ttb.get_legal_action_set() == jtb.get_legal_action_set()
    assert (ttb.get_width(), ttb.get_height()) == (jtb.get_width(),
                                                   jtb.get_height())
    assert ttb.schema_for_state() == jtb.schema_for_state()
    assert ttb.schema_for_config() == jtb.schema_for_config()
    r = np.random.default_rng(5)
    legal = jtb.get_legal_action_set()
    _assert_same(jtb, ttb, "at the start")
    for i in range(120):
        a = 1 if i % 9 == 0 else int(r.choice(legal))
        jtb.apply_ale_action(a)
        ttb.apply_ale_action(a)
        if i % 40 == 39:
            _assert_same(jtb, ttb, f"after {i + 1} actions")
            np.testing.assert_array_equal(ttb.get_state(), jtb.get_state())
            np.testing.assert_array_equal(ttb.get_rgba_frame(),
                                          jtb.get_rgba_frame())
    ttb.grayscale = jtb.grayscale = False
    np.testing.assert_array_equal(ttb.get_state(), jtb.get_state())
    assert ttb.get_state().shape[-1] == 4


@pytest.mark.parametrize("game", ["breakout", "space_invaders", "amidar"])
def test_json_written_into_the_facade_reads_back(game):
    jtb, ttb = _pair(game, 9)
    for _ in range(30):
        jtb.apply_ale_action(1)
    js = jtb.to_state_json()
    ttb.write_state_json(json.dumps(js))
    assert ttb.to_state_json() == js
    ttb.write_state_json(ttb.to_state_json())
    assert ttb.to_state_json() == js
    # a config written into both facades, then a new game from it
    cfg = jtb.config_to_json()
    cfg["start_lives"] = 2
    cfg["rand"] = {"state": [5, 6]}
    for tb in (jtb, ttb):
        tb.write_config_json(json.dumps(cfg))
        tb.new_game()
    assert ttb.config_to_json() == jtb.config_to_json() == cfg
    _assert_same(jtb, ttb, "after the config write")
    assert ttb.get_lives() == 2
    # withstate= starts the facade from a state
    ttb2 = toybox_tpu_torch.Toybox(game, device="cpu", withstate=js)
    assert ttb2.to_state_json() == js


def test_set_seed_and_input_match_jax():
    jtb, ttb = _pair("breakout", None)
    for pkg, tb in ((toybox_tpu, jtb), (toybox_tpu_torch, ttb)):
        tb.set_seed(4242)
        tb.new_game()
        tb.apply_action(pkg.Input(button1=True))
        for _ in range(5):
            tb.apply_action(pkg.Input(right=True))
    _assert_same(jtb, ttb, "after set_seed")
    with ttb as tb:
        assert tb.game_over() is False
    assert ttb.rstate is None


def test_every_game_is_ported_and_unknown_games_raise():
    tb = toybox_tpu_torch.Toybox("gridworld", device="cpu")
    assert tb.get_lives() == 1 and tb.get_state().shape == (112, 144, 1)
    assert set(toybox_tpu_torch.GAMES) == set(toybox_tpu.games.GAMES)
    for game in toybox_tpu.games.GAMES:
        assert toybox_tpu_torch.get_game(game).GAME_NAME == game
    with pytest.raises(ValueError, match="pong"):
        toybox_tpu_torch.get_game("pong")
    with pytest.raises(ValueError, match="pong"):
        toybox_tpu_torch.Toybox("pong", device="cpu")


def test_save_frame_image_writes_the_frame(tmp_path):
    from PIL import Image

    ttb = toybox_tpu_torch.Toybox("space_invaders", seed=3, device="cpu")
    ttb.save_frame_image(str(tmp_path / "grey.png"))
    ttb.save_frame_image(str(tmp_path / "rgba.png"), grayscale=False)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "grey.png")), ttb.get_state()[..., 0])
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "rgba.png")), ttb.get_rgba_frame())
    assert ttb.get_rgb_frame().shape == (210, 320, 3)

"""The port's seed-state extraction (run_get_seed_state.py) against the JAX
package's: every case of tests/test_seed_states.py on the port's facade,
and the random-policy extraction giving JAX's state JSON and frame."""

import json
import os

import pytest

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu import run_get_seed_state as jseed
from toybox_tpu_torch import Toybox
from toybox_tpu_torch.run_get_seed_state import (PREDICATES,
                                                 extract_seed_state, main)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures",
                           "seed_states")


def _load(name):
    with open(os.path.join(FIXTURE_DIR, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("fixture,predicate", [
    ("breakout_channel_seed0.json", "channel"),
    ("breakout_last_brick_seed0.json", "last_brick"),
    ("breakout_life_lost_seed0.json", "life_lost"),
])
def test_fixture_predicate_holds_after_load(fixture, predicate):
    tb = Toybox("breakout", withstate=_load(fixture), device="cpu")
    assert PREDICATES[predicate](tb)


def test_fixture_roundtrips_and_resumes():
    js = _load("breakout_last_brick_seed0.json")
    tb = Toybox("breakout", withstate=js, device="cpu")
    assert tb.to_state_json() == js
    assert tb.rstate.breakout_bricks_remaining() == 1
    for _ in range(100):
        tb.apply_ale_action(1)
    assert tb.get_lives() >= 0


def test_life_lost_semantics_match_start_lives():
    for game in ("breakout", "amidar", "space_invaders"):
        assert not PREDICATES["life_lost"](Toybox(game, seed=0,
                                                  device="cpu")), game
    assert _load("breakout_life_lost_seed0.json")["lives"] == 4


@pytest.mark.parametrize("predicate", ["life_lost", "score_100"])
def test_random_extraction_matches_jax(predicate):
    """The random policy (seed 0) against JAX's: the same state JSON and
    frame index, or both never holding within the cap."""
    mine = extract_seed_state("breakout", predicate, max_frames=400,
                              seed=0, device="cpu")
    assert mine == jseed.extract_seed_state("breakout", predicate,
                                            max_frames=400, seed=0)
    if predicate == "life_lost":
        assert mine[1] >= 0 and mine[0]["lives"] == 4


def test_cli_writes_the_state(tmp_path, capsys):
    assert main(["--predicate=life_lost", "--max_frames=400",
                 f"--out={tmp_path}", "--device=cpu"]) == 0
    js = json.load(open(tmp_path / "breakout_life_lost_seed0.json"))
    assert js == extract_seed_state("breakout", "life_lost", 400,
                                    device="cpu")[0]
    assert main(["--predicate=last_brick", "--max_frames=5",
                 f"--out={tmp_path}", "--device=cpu"]) == 1
    assert "never held" in capsys.readouterr().out

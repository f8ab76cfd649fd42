"""reset_to from each amidar scenario's captured set-up (reseed=False) and a
fixed action script through the port's pipeline on the CPU against the
JAX pipeline: the same per-env state JSON, rewards, done and lives, and
observations within 1 grey level (tests/test_torch_gate.py)."""

import pytest

from tests.test_torch_gate import check_reset_to_trajectory
from tests.test_torch_codecs import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("scenario", ["EnemyRemoval", "OneEnemyTarget",
                                      "GangUpNoJumpRandom",
                                      "GangUpNoJumpTarget"])
def test_reset_to_trajectory_matches_jax(scenario):
    check_reset_to_trajectory("amidar", scenario)

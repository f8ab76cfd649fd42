"""Lock-step serve trajectories of the Breakout eval heads against the
JAX package, through ``check_trajectory`` of
tests/test_torch_trajectory.py (its draws, near-tie rule and tolerances):
2 games at the regress settings, seed 0, 160 agent steps each, JAX's
random draws fed to the port's head at every step.

- ``Breakout.acer.model``: acer's pi, its Q head beside it;
- ``Breakout.deepq.model``: the greedy dueling Q with JAX's epsilon
  draws (explore mask and random action);
- ``Breakout.ppo_lstm.model``: the LSTM carry, threaded in each stack;
- ``Breakout.ppo_bf16.model``: the bf16-trained model, played in f32.

(acktr's K-FAC net is held on Amidar in tests/test_torch_trajectory.py.)
"""

import pytest

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_trajectory import check_trajectory


@pytest.mark.parametrize("model", [
    "Breakout.acer.model", "Breakout.deepq.model",
    "Breakout.ppo_lstm.model", "Breakout.ppo_bf16.model"])
def test_head_trajectory_follows_jax(model):
    check_trajectory(model, 160)

"""The learning tests of the replay learners and TRPO in the port, each
at the JAX package's threshold on its task and budget
(tests/test_rl_learning.py): deepq with epsilon-greedy and with
parameter noise (greedy accuracy >= 0.75, :51-92), trpo (> 0.6, :95),
acer (> 0.7, :106) and recurrent acer on the fixed sequence (> 0.6,
:421). The envs are the port's copies of the JAX fixtures, with their
own draws.
"""

import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu_torch.rl import acer, dqn, trpo
from toybox_tpu_torch.rl.test_envs import (make_discrete_identity_env,
                                           make_fixed_sequence_env)


@pytest.mark.parametrize("param_noise", [False, True])
def test_dqn_learns_identity(param_noise):
    """tests/test_rl_learning.py:51-92 in the port (both tests)."""
    env = make_discrete_identity_env(8, dim=4, device="cpu")
    init_fn, cycle, qnet = dqn.make_dqn(
        env, network="mlp", lr=5e-3, buffer_size=2048, batch_size=64,
        train_freq=2, learning_starts=128, target_network_update_freq=100,
        exploration_fraction=0.3, exploration_final_eps=0.02,
        total_timesteps=4000, param_noise=param_noise,
        param_noise_scale0=0.1, network_kwargs=dict(num_hidden=32),
        device="cpu")
    state = init_fn(0)
    for _ in range(250):
        state, metrics = cycle(state)
    if param_noise:
        assert float(metrics["param_noise_scale"]) > 0.0
    with torch.no_grad():
        acc = float((qnet(torch.eye(4)).argmax(-1) == torch.arange(4))
                    .float().mean())
    assert acc >= 0.75, f"dqn (param_noise={param_noise}) failed: {acc}"


def test_trpo_learns_identity():
    """tests/test_rl_learning.py:95-103 in the port."""
    env = make_discrete_identity_env(16, dim=4, device="cpu")
    init_fn, step = trpo.make_trpo(env, network="mlp", nsteps=32,
                                   max_kl=0.01, vf_stepsize=1e-2, vf_iters=3,
                                   network_kwargs=dict(num_hidden=32),
                                   device="cpu")
    state = init_fn(0)
    for _ in range(40):
        state, metrics = step(state)
    r = float(metrics["mean_reward"])
    assert r > 0.6, f"trpo failed to learn identity: {r}"


def test_acer_learns_identity():
    """tests/test_rl_learning.py:106-113 in the port."""
    env = make_discrete_identity_env(16, dim=4, device="cpu")
    init_fn, cycle = acer.make_acer(
        env, network="mlp", nsteps=8, lr=5e-3, gamma=0.1, replay_ratio=2,
        buffer_traj=16, network_kwargs=dict(num_hidden=32), device="cpu")
    state = init_fn(0)
    for _ in range(400):
        state, metrics = cycle(state)
    r = float(metrics["mean_reward"])
    assert r > 0.7, f"acer failed to learn identity: {r}"


def test_recurrent_acer_learns_fixed_sequence():
    """tests/test_rl_learning.py:421-437 in the port."""
    env = make_fixed_sequence_env(16, n_actions=3, episode_len=8,
                                  device="cpu")
    init_fn, cycle = acer.make_acer(
        env, network="lstm", nlstm=32, nsteps=8, lr=1e-2, gamma=0.5,
        replay_ratio=4, buffer_traj=10, ent_coef=0.001,
        network_kwargs=dict(num_hidden=32), device="cpu")
    state = init_fn(0)
    for _ in range(600):
        state, metrics = cycle(state)
    r = float(metrics["mean_reward"])
    assert r > 0.6, f"recurrent acer failed to memorize the sequence: {r}"

"""``python -m toybox_tpu_torch.run`` trains and saves each on-policy
learner ported after PPO (a2c, acktr, recurrent ppo, ppo1) on the CPU,
and the saved file loads with the JAX package's ``load_params`` (into
the JAX module's own template) and with the port's ``load_eval_params``,
with equal params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl.acktr import KfacCNNPolicy as JKfacCNNPolicy
from toybox_tpu.rl.models import LSTMTrunk, get_network_builder
from toybox_tpu.rl.policies import build_policy as j_build_policy
from toybox_tpu.rl.ppo_recurrent import RecurrentPolicyWithValue
from toybox_tpu_torch import run
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.eval_adapter import load_eval_params

OBS = (84, 84, 4)


def _jax_template(alg, network):
    key = jax.random.PRNGKey(0)
    if alg == "acktr":
        return JKfacCNNPolicy(n_actions=4).init(
            key, jnp.zeros((1,) + OBS, jnp.uint8))
    if network == "cnn":
        return j_build_policy(OBS, 4, network)[1](key)
    trunk = get_network_builder(network)(nlstm=128)
    return RecurrentPolicyWithValue(trunk=trunk, n_actions=4).init(
        key, jnp.zeros((2,) + OBS, jnp.uint8),
        LSTMTrunk.initial_carry(2, 128), jnp.zeros(2, bool))


@pytest.mark.parametrize("args,alg,network,updates", [
    (["--alg=a2c", "--num_envs=2", "--num_timesteps=160",
      "--updates_per_jit=2"], "a2c", "cnn", 4),
    (["--alg=acktr", "--num_envs=2", "--nsteps=4", "--num_timesteps=64",
      "--updates_per_jit=2", "--invert_every=16", "--kfac_clip=0.01"],
     "acktr", "cnn", 2),
    (["--alg=ppo", "--network=cnn_lstm", "--num_envs=2", "--nsteps=4",
      "--nminibatches=2", "--noptepochs=1", "--num_timesteps=64"], "ppo",
     "cnn_lstm", 2),
    (["--alg=ppo1", "--num_envs=2", "--nsteps=4", "--optim_batchsize=4",
      "--noptepochs=1", "--num_timesteps=64"], "ppo1", "cnn", 2),
])
def test_run_main_trains_and_saves(args, alg, network, updates, tmp_path):
    path = str(tmp_path / "model")
    state = run.main(args + ["--env=BreakoutToyboxNoFrameskip-v4",
                             "--device=cpu", f"--save_path={path}",
                             f"--log_path={tmp_path / 'log'}"])
    assert state.update == updates
    want = state.module.state_dict()
    template = _jax_template(alg, network)
    loaded = jax.tree_util.tree_map(np.asarray,
                                    jppo.load_params(path, template))
    assert jax.tree_util.tree_structure(loaded) == \
        jax.tree_util.tree_structure(template)
    back = params_from_flax(loaded)
    head = load_eval_params(alg, network, path, "breakout", device="cpu")
    for k, v in want.items():
        assert torch.equal(back[k], v), k
        assert torch.equal(head.state_dict()[k], v), k

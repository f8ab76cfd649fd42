"""PPO Breakout's recipe against the JAX package beyond the first update:
the training rollout (episodic life, clipped rewards, the in-kernel warp
form the port trains on) and the update at the recipe's annealing points.

- The rollout: JAX's ``make_ppo`` rollout from ``init_fn(0)`` (4 envs,
  64 agent steps, the default env: episodic life, clipped rewards)
  against ``ppo.rollout`` on the port's ``make_rl_env(...,
  inkernel_warp=True)`` from the same env seeds, fed JAX's Gumbel noise
  (its key schedule). Actions, clipped rewards, dones (a life lost ends a
  training episode) and finished games' raw returns must be equal; values
  within 1e-4 (the observations may differ by 1 grey level where a warp
  sum lands next to a half-integer); at least one life lost and one
  reward.
- The update at the recipe's annealing points: 228 updates (1.2e8 frames
  of 1 024 x 128 x 4), JAX's ``train_step`` from ``init_fn(0)`` with its
  update count set to 114 and 227 against the port's update at
  ``anneal(u, 228)`` fed JAX's rollout and permutations; params within
  0.4 % of one Adam step at that update's lr (1e-6 at lr 2.5e-4, as in
  tests/test_torch_ppo.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_ppo import _closure, _np_tree
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import ppo as jppo
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.policies import build_policy, noise_step

NENVS, NSTEPS, NMB, NEPOCHS = 4, 64, 2, 1
TOTAL = 120_000_000 // (1024 * 128 * 4)          # the recipe's 228 updates


@pytest.fixture(scope="module")
def jax_recipe():
    env = j_make_rl_env("breakout", NENVS)
    init_fn, train_step, _ = jppo.make_ppo(
        env, network="cnn", nsteps=NSTEPS, nminibatches=NMB,
        noptepochs=NEPOCHS, total_updates=TOTAL)
    state0 = init_fn(0)
    rollout = _closure(train_step, "_rollout")
    jgae = _closure(train_step, "_gae")
    p_value = _closure(train_step, "p_value")

    @jax.jit
    def replay(state):
        def noise(key, _):
            key, akey = jax.random.split(key)
            return key, jax.random.gumbel(akey, (NENVS, env.num_actions),
                                          jnp.float32)

        _, gumbels = jax.lax.scan(noise, state.key, None, length=NSTEPS)
        env_state, key, traj = rollout(state.params, state.env_state,
                                       state.key)
        obs, actions, values, neglogps, rewards, dones, ep_ret = traj[:7]
        last_value = p_value(state.params, env_state.frames)
        advs = jgae(values, rewards, dones, last_value)
        key, *ekeys = jax.random.split(key, NEPOCHS + 1)
        perms = jnp.stack([jax.random.permutation(k, NSTEPS * NENVS)
                           for k in ekeys])
        return dict(obs=obs, actions=actions, values=values,
                    neglogps=neglogps, rewards=rewards, dones=dones,
                    ep_ret=ep_ret, advs=advs, perms=perms, gumbels=gumbels)

    _, _, ekey = jax.random.split(jax.random.PRNGKey(0), 3)
    seeds = jax.random.randint(ekey, (NENVS,), 0, 2**31 - 1)
    return dict(state0=state0, train_step=jax.jit(train_step),
                inputs=_np_tree(replay(state0)), seeds=np.asarray(seeds))


def _port_policy(state0):
    tenv = t_make_rl_env("breakout", NENVS, inkernel_warp=True,
                         device="cpu")
    module, _, _, _ = build_policy(tenv.obs_shape, tenv.num_actions, "cnn",
                                   device="cpu")
    module.load_state_dict(params_from_flax(_np_tree(state0.params)))
    return tenv, module


def test_training_rollout_matches_jax(jax_recipe):
    x = jax_recipe["inputs"]
    tenv, module = _port_policy(jax_recipe["state0"])
    st, _ = tenv.reset(torch.as_tensor(jax_recipe["seeds"].astype(np.int64)))
    buf = ppo.Rollout.empty(NSTEPS, NENVS, st.frames)
    step_fn = noise_step(module, noise=iter(torch.from_numpy(x["gumbels"].copy())))
    ppo.rollout(step_fn, tenv, st, None, buf)
    lives_lost = int(x["dones"].sum())
    print(f"{lives_lost} training episodes ended, rewards "
          f"{float(x['rewards'].sum())}, largest value difference "
          f"{float(np.abs(buf.values.numpy() - x['values']).max()):.3g}")
    assert lives_lost > 0 and x["rewards"].sum() > 0
    np.testing.assert_array_equal(buf.actions.numpy(), x["actions"])
    np.testing.assert_array_equal(buf.rewards.numpy(), x["rewards"])
    np.testing.assert_array_equal(buf.dones.numpy(), x["dones"])
    np.testing.assert_array_equal(np.isnan(buf.ep_ret.numpy()),
                                  np.isnan(x["ep_ret"]))
    np.testing.assert_array_equal(np.nan_to_num(buf.ep_ret.numpy()),
                                  np.nan_to_num(x["ep_ret"]))
    np.testing.assert_allclose(buf.values.numpy(), x["values"], rtol=0,
                               atol=1e-4)
    grey = np.abs(buf.obs.numpy().astype(int) - x["obs"].astype(int))
    assert grey.max() <= 1


@pytest.mark.parametrize("u", [TOTAL // 2, TOTAL - 1])
def test_annealed_update_matches_jax(jax_recipe, u):
    x = jax_recipe["inputs"]
    state0 = jax_recipe["state0"].replace(update=jnp.asarray(u, jnp.int32))
    state1, _ = jax_recipe["train_step"](state0)
    _, module = _port_policy(state0)
    adam = ppo.AdamState.zeros_like(list(module.parameters()))
    t = {k: torch.tensor(v) for k, v in x.items()}
    returns = t["advs"] + t["values"]
    nbatch = NSTEPS * NENVS
    batch = tuple(v.reshape((nbatch,) + tuple(v.shape[2:])) for v in (
        t["obs"], t["actions"].long(), t["values"], t["neglogps"], returns,
        t["advs"]))
    lrnow, cliprnow = ppo.anneal(u, TOTAL, 2.5e-4, 0.1)
    assert abs(lrnow - 2.5e-4 * max(1 - u / TOTAL, 0.01)) < 1e-6 * lrnow
    ppo.update(module, adam, batch, list(t["perms"].long()), lrnow,
               cliprnow, ppo.Hyper(nminibatches=NMB), 4)
    want = params_from_flax(_np_tree(state1.params))
    before = params_from_flax(_np_tree(state0.params))
    moved = max(float((want[k] - before[k]).abs().max()) for k in want)
    got = module.state_dict()
    print(f"update {u} of {TOTAL}: lr {lrnow:.3g}, params moved up to "
          f"{moved:.3g}, port vs JAX "
          f"{max(float((got[k] - want[k]).abs().max()) for k in want):.3g}")
    assert moved > 0.5 * lrnow
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6 * lrnow / 2.5e-4, err_msg=k)

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
- The update from a mid-run Adam state: JAX's state after two real
  updates (non-zero moments), its update count set to 114 and 227 and
  its Adam count to that update's count in the recipe (16 Adam steps an
  update: 1 824 and 3 632, where the bias correction of the second
  moment is 0.84 and 0.97), against the port's update from the moments
  ``checkpoint.adam_from_optax`` carries over, fed JAX's rollout and
  permutations from that state; the same bound.
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
from toybox_tpu_torch.rl.checkpoint import adam_from_optax, params_from_flax
from toybox_tpu_torch.rl.policies import build_policy, noise_step

NENVS, NSTEPS, NMB, NEPOCHS = 4, 64, 2, 1
TOTAL = 120_000_000 // (1024 * 128 * 4)          # the recipe's 228 updates
ADAM_STEPS = 4 * 4                       # the recipe's minibatches x epochs


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
                replay=replay, inputs=_np_tree(replay(state0)),
                seeds=np.asarray(seeds))


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


def _held_update(jax_recipe, state0, x, u, adam_of):
    """JAX's train_step from ``state0`` (its update count set to ``u``)
    against the port's ``ppo.update`` at ``anneal(u, TOTAL)`` from the
    same params and the Adam state ``adam_of(state0, module)``, fed the
    rollout and permutations ``x`` replayed from ``state0``."""
    state1, _ = jax_recipe["train_step"](state0)
    _, module = _port_policy(state0)
    adam = adam_of(state0, module)
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
    return adam


@pytest.mark.parametrize("u", [TOTAL // 2, TOTAL - 1])
def test_annealed_update_matches_jax(jax_recipe, u):
    state0 = jax_recipe["state0"].replace(update=jnp.asarray(u, jnp.int32))
    _held_update(jax_recipe, state0, jax_recipe["inputs"], u,
                 lambda _, m: ppo.AdamState.zeros_like(
                     list(m.parameters())))


@pytest.fixture(scope="module")
def jax_mid_run(jax_recipe):
    """JAX's state after two real updates from init_fn(0)."""
    state = jax_recipe["state0"]
    for _ in range(2):
        state, _ = jax_recipe["train_step"](state)
    return state


@pytest.mark.parametrize("u", [TOTAL // 2, TOTAL - 1])
def test_update_from_carried_adam_state_matches_jax(jax_recipe, jax_mid_run,
                                                    u):
    clip, adam, *rest = jax_mid_run.opt_state
    assert type(adam).__name__ == "ScaleByAdamState" and int(adam.count) > 0
    adam = adam._replace(count=jnp.asarray(u * ADAM_STEPS, adam.count.dtype))
    state0 = jax_mid_run.replace(update=jnp.asarray(u, jnp.int32),
                                 opt_state=(clip, adam, *rest))
    x = _np_tree(jax_recipe["replay"](state0))

    def carried(state, module):
        got = adam_from_optax(_np_tree(state.opt_state[1]), module)
        assert got.count == u * ADAM_STEPS
        assert max(float(m.abs().max()) for m in got.mu) > 0
        return got

    got = _held_update(jax_recipe, state0, x, u, carried)
    assert got.count == u * ADAM_STEPS + NMB * NEPOCHS

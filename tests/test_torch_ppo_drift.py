"""PPO Breakout over several consecutive updates: the port against the JAX
package, read against the training's own chaos.

From about its third update on, PPO here is chaotic: a difference at
float level grows by orders of magnitude in one update (Adam's first
steps turn the sign of a gradient near zero into a whole step of the
lr), then by 1.3-5 times an update, until it saturates at the size of
one update. So the port cannot be held to JAX at a fixed tolerance over
many updates. It is held instead against a yardstick: JAX against
itself (JAX'), started from its own params scaled by (1 + 1e-7 N(0, 1))
(numpy, seed 0) and fed the same keys.

K = 6 consecutive updates at 4 envs x 32 steps with the recipe's 4
minibatches x 4 epochs, lr and clip annealed over its 228 updates, on
Breakout with 3 lives so that whole games end inside the K updates. JAX's
``train_step`` runs from ``init_fn(0)``; the port runs ``make_ppo``'s own
``collect`` and ``optimize`` (as ``learn`` calls them) from JAX's params
and env seeds, carrying its own params, Adam state and env state. Its
draws come from JAX's key schedule: ``policies.gumbel`` (the Gumbel noise
of ``noise_step``) and ``torch.randperm`` (the epoch permutations) are
replaced by JAX's through monkeypatch. Both build the env with the
matmul warp (``make_rl_env``'s default, JAX's training obs path).

Where the port's argmax differs from JAX's action, the port takes JAX's
action and the flip is kept with its margin (JAX's top two logits + g)
and the step's largest logit difference. Asserted:

- after updates 0 and 1, the port's params within 1e-6 of JAX's;
- after every update, the port's largest param difference from JAX at
  most twice JAX's from JAX';
- rewards, dones and finished games equal at every step (at least one
  game over inside the K updates), observations within 1 grey level;
- every flip a near tie (margin at most twice the difference, the rule
  of scripts/gate_vs_jax.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_ppo import _closure, _np_tree
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.games import breakout as j_breakout
from toybox_tpu.rl import ppo as jppo
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.games import breakout as t_breakout
from toybox_tpu_torch.rl import policies, ppo
from toybox_tpu_torch.rl.checkpoint import params_from_flax

NENVS, NSTEPS, NMB, NEPOCHS, K = 4, 32, 4, 4, 6
TOTAL = 120_000_000 // (1024 * 128 * 4)          # the recipe's 228 updates
LIVES = 3
EPS = 1e-7                                       # JAX' relative perturbation


def _jax_env():
    cfg = j_breakout.default_config().replace(
        start_lives=jnp.asarray(LIVES, jnp.int32))
    return j_make_rl_env("breakout", NENVS, config=cfg)


def _port_env():
    cfg = t_breakout.config_from_json(
        dict(t_breakout.config_to_json(t_breakout.default_config("cpu")),
             start_lives=LIVES), device="cpu")
    return t_make_rl_env("breakout", NENVS, config=cfg, device="cpu")


def _flat(params) -> dict:
    return params_from_flax(_np_tree(params))


def _distance(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's K updates from init_fn(0) (jitted: one compile instead of
    its ops one by one): each update's draws, actions,
    logits and trajectory (replayed with its key schedule), its params
    after each update, and JAX' (the perturbed start) after each."""
    env = _jax_env()
    init_fn, train_step, _ = jppo.make_ppo(
        env, network="cnn", nsteps=NSTEPS, nminibatches=NMB,
        noptepochs=NEPOCHS, total_updates=TOTAL)
    rollout = _closure(train_step, "_rollout")
    module = _closure(_closure(train_step, "_loss"), "module")

    @jax.jit
    def step(state):
        """train_step, and its update's draws and trajectory replayed
        with its key schedule (one program: one compile for both)."""
        def noise(key, _):
            key, akey = jax.random.split(key)
            return key, jax.random.gumbel(akey, (NENVS, env.num_actions),
                                          jnp.float32)

        _, gumbels = jax.lax.scan(noise, state.key, None, length=NSTEPS)
        _, key, traj = rollout(state.params, state.env_state, state.key)
        obs, actions, _, _, rewards, dones, ep_ret = traj[:7]
        logits, _ = module.apply(state.params,
                                 obs.reshape((-1,) + obs.shape[2:]))
        key, *ekeys = jax.random.split(key, NEPOCHS + 1)
        perms = jnp.stack([jax.random.permutation(k, NSTEPS * NENVS)
                           for k in ekeys])
        return train_step(state)[0], dict(
            gumbels=gumbels, actions=actions,
            logits=logits.reshape(actions.shape + (-1,)), obs=obs,
            rewards=rewards, dones=dones, ep_ret=ep_ret, perms=perms)

    state0 = jax.jit(init_fn, static_argnums=0)(0)
    state, updates, params = state0, [], []
    for _ in range(K):
        state, replayed = step(state)
        updates.append(_np_tree(replayed))
        params.append(_flat(state.params))

    rng = np.random.default_rng(0)
    state = state0.replace(params=jax.tree_util.tree_map(
        lambda p: jnp.asarray((np.asarray(p, np.float64) * (
            1 + EPS * rng.standard_normal(p.shape))).astype(np.float32)),
        state0.params))
    yardstick = []
    for k in range(K):
        state, _ = step(state)
        yardstick.append(_distance(_flat(state.params), params[k]))

    _, _, ekey = jax.random.split(jax.random.PRNGKey(0), 3)
    seeds = jax.random.randint(ekey, (NENVS,), 0, 2**31 - 1)
    return dict(params0=_flat(state0.params), seeds=np.asarray(seeds),
                updates=updates, params=params, yardstick=yardstick)


def test_many_updates_drift_within_chaos(jax_run, monkeypatch):
    updates = jax_run["updates"]
    at = {}                                  # the (update, step) drawn now
    clock = iter([(k, t) for k in range(K) for t in range(NSTEPS)])
    perms = iter([torch.from_numpy(p.astype(np.int64))
                  for u in updates for p in u["perms"]])
    flips = []
    gumbel_max = policies.gumbel_max

    def jax_gumbel(shape, generator, device, dtype=torch.float32):
        at["k"], at["t"] = next(clock)
        return torch.from_numpy(updates[at["k"]]["gumbels"][at["t"]].copy())

    def jax_action(logits, noise):
        """The port's argmax, or JAX's action where they differ."""
        u, t = updates[at["k"]], at["t"]
        want = torch.from_numpy(u["actions"][t].astype(np.int64))
        got = gumbel_max(logits, noise)
        diff = float(np.abs(u["logits"][t] - logits.numpy()).max())
        for e in np.flatnonzero(got.numpy() != want.numpy()):
            top = np.sort(u["logits"][t][e] + u["gumbels"][t][e])
            flips.append((at["k"], t, int(e), float(top[-1] - top[-2]),
                          diff))
        return want.to(got.dtype)

    def jax_randperm(n, generator=None, device=None):
        p = next(perms)
        assert len(p) == n
        return p

    monkeypatch.setattr(policies, "gumbel", jax_gumbel)
    monkeypatch.setattr(policies, "gumbel_max", jax_action)
    monkeypatch.setattr(torch, "randperm", jax_randperm)

    env = _port_env()
    init_fn, train_step, _ = ppo.make_ppo(
        env, network="cnn", nsteps=NSTEPS, nminibatches=NMB,
        noptepochs=NEPOCHS, total_updates=TOTAL, device="cpu")
    state = init_fn(0)
    state.module.load_state_dict(jax_run["params0"])
    state.env_state, _ = env.reset(
        torch.as_tensor(jax_run["seeds"].astype(np.int64)))

    games, grey, drift = 0, 0, []
    for k in range(K):
        u = updates[k]
        collected = train_step.collect(state)
        buf = collected[1]
        np.testing.assert_array_equal(buf.rewards.numpy(), u["rewards"],
                                      err_msg=f"update {k}")
        np.testing.assert_array_equal(buf.dones.numpy(), u["dones"],
                                      err_msg=f"update {k}")
        np.testing.assert_array_equal(np.nan_to_num(buf.ep_ret.numpy(), nan=-1),
                                      np.nan_to_num(u["ep_ret"], nan=-1),
                                      err_msg=f"update {k}")
        games += int((~np.isnan(u["ep_ret"])).sum())
        grey = max(grey, int(np.abs(buf.obs.numpy().astype(int)
                                    - u["obs"].astype(int)).max()))
        state, _ = train_step.optimize(state, collected)
        drift.append(_distance(state.module.state_dict(),
                               jax_run["params"][k]))

    yard = jax_run["yardstick"]
    for k in range(K):
        print(f"after update {k}: port-JAX {drift[k]:.3g}, JAX-JAX' "
              f"{yard[k]:.3g} ({drift[k] / yard[k]:.3g} of it)")
    print(f"{games} games over, observations {grey} grey levels apart, "
          f"{len(flips)} flips (update, step, env, margin, difference): "
          f"{flips}")
    assert state.update == K and state.adam.count == K * NMB * NEPOCHS
    assert games > 0, "no game over inside the updates"
    assert grey <= 1
    assert max(drift[:2]) <= 1e-6, drift
    for k in range(K):
        assert drift[k] <= 2 * yard[k], (k, drift, yard)
    for f in flips:
        assert f[3] <= 2 * f[4], f"not a near tie: {f}"

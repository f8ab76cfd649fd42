"""The port's recurrent PPO (toybox_tpu_torch.rl.ppo_recurrent) against the
JAX package's.

- One ``make_recurrent_ppo`` update from ``init_fn(0)``: lstm on the
  fixed-sequence env (4 envs x nsteps 8, episodes of 3 steps), and
  cnn_lstm on Breakout (4 envs x nsteps 8): the JAX ``train_step``
  against the port's GAE and update fed the JAX rollout, the JAX env
  permutations (env-major minibatches of 2 envs, 2 epochs) and the JAX
  params, the rollout replayed with JAX's key schedule. Tolerance: params
  within 1e-6 absolute, metrics within 1e-5 relative or 1e-7 absolute.
- The unrolled forward equals the step-by-step forward.
- The fixed-sequence learning test (> 0.6), tests/test_rl_learning.py:228.
- ``ppo.learn`` dispatches the recurrent networks to
  ``ppo_recurrent.learn``; the saved file reads in JAX's ``load_params``.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_a2c import (_assert_metrics, _assert_params, _np,
                                  _replay_recurrent)
from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl import ppo_recurrent as jrec
from toybox_tpu.rl.test_envs import make_fixed_sequence_env as j_fixed_seq
from toybox_tpu_torch.rl import ppo, ppo_recurrent
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.test_envs import (make_discrete_identity_env,
                                           make_fixed_sequence_env)

NSTEPS, NENVS, NMB, NEPOCHS = 8, 4, 2, 2


def _jax_update(env, **kw):
    """(inputs, state0, state1, metrics) of one JAX train_step, its rollout
    and epoch permutations replayed outside it."""
    init_fn, train_step, _ = jrec.make_recurrent_ppo(
        env, nsteps=NSTEPS, nminibatches=NMB, noptepochs=NEPOCHS, **kw)
    replay = _replay_recurrent(train_step, env, NSTEPS)
    state0 = init_fn(0)
    x = replay(state0)
    key, *ekeys = jax.random.split(x["key"], NEPOCHS + 1)
    perms = np.stack([np.asarray(jax.random.permutation(k, NENVS))
                      for k in ekeys])
    state1, metrics = jax.jit(train_step)(state0)
    return dict(_np(x), perms=perms), state0, state1, _np(metrics)


@pytest.mark.parametrize("network,game", [("lstm", "fixed_sequence"),
                                          ("cnn_lstm", "breakout")])
def test_one_update_matches_jax_train_step(network, game):
    if game == "breakout":
        env = j_make_rl_env("breakout", NENVS)
        kw = dict(network=network, nlstm=32)
    else:
        env = j_fixed_seq(NENVS, n_actions=3, episode_len=3)
        kw = dict(network=network, nlstm=16, lr=5e-3, cliprange=0.2,
                  network_kwargs=dict(num_hidden=16))
    x, state0, state1, jmetrics = _jax_update(env, **kw)
    if game == "fixed_sequence":
        assert x["prev_dones"].any()          # the carry resets inside
    module, _ = ppo_recurrent.build_recurrent_policy(
        env.obs_shape, env.num_actions, network, kw["nlstm"], "cpu",
        kw.get("network_kwargs"))
    module.load_state_dict(params_from_flax(_np(state0.params)))
    t = {k: torch.tensor(v) for k, v in x.items() if k != "carry0"}
    advs = ppo.gae(t["values"], t["rewards"], t["dones"], t["last_value"],
                   0.99, 0.95)
    rb = ppo_recurrent.RecurrentBatch(
        obs=t["obs"], actions=t["actions"].long(), values=t["values"],
        neglogps=t["neglogps"], returns=advs + t["values"], advs=advs,
        prev_dones=t["prev_dones"],
        carry0=tuple(torch.tensor(c) for c in x["carry0"]))
    lrnow, cliprnow = ppo.anneal(0, 1, kw.get("lr", 2.5e-4),
                                 kw.get("cliprange", 0.1))
    metrics = ppo_recurrent.update(
        module, ppo.AdamState.zeros_like(list(module.parameters())), rb,
        list(t["perms"].long()), lrnow, cliprnow,
        ppo.Hyper(nminibatches=NMB), env.num_actions)
    worst = _assert_params(module.state_dict(), state1.params,
                           state0.params)
    print(f"{network}: port vs JAX max diff {worst:.3g}")
    _assert_metrics(metrics, jmetrics, ppo_recurrent.METRICS)


def test_unroll_equals_stepping():
    module, init = ppo_recurrent.build_recurrent_policy(
        (84, 84, 4), 4, "cnn_lnlstm", 8, "cpu")
    init(3)
    g = torch.Generator().manual_seed(0)
    obs = torch.randint(0, 256, (5, 3, 84, 84, 4), generator=g,
                        dtype=torch.uint8)
    dones = torch.rand((5, 3), generator=g) < 0.3
    carry = tuple(torch.randn((3, 8), generator=g) for _ in range(2))
    with torch.no_grad():
        logits, values, last = module.unroll(obs, carry, dones)
        c = carry
        for t in range(5):
            lt, vt, c = module(obs[t], c, dones[t])
            torch.testing.assert_close(logits[t], lt, rtol=0, atol=1e-6)
            torch.testing.assert_close(values[t], vt, rtol=0, atol=1e-6)
    for a, b in zip(last, c):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_recurrent_ppo_learns_fixed_sequence():
    """tests/test_rl_learning.py:228-245 in the port."""
    env = make_fixed_sequence_env(16, n_actions=3, episode_len=8,
                                  device="cpu")
    init_fn, step, _ = ppo_recurrent.make_recurrent_ppo(
        env, network="lstm", nlstm=32, nsteps=16, nminibatches=2,
        noptepochs=4, lr=5e-3, cliprange=0.2, gamma=0.5,
        total_updates=4000, network_kwargs=dict(num_hidden=32),
        device="cpu")
    state = init_fn(0)
    for _ in range(300):
        state, last = step(state)
    r = float(last["mean_reward"])
    assert r > 0.6, f"recurrent ppo failed to memorize the sequence: {r}"


def test_ppo_learn_dispatches_recurrent_networks(tmp_path, monkeypatch):
    calls = []
    rlearn = ppo_recurrent.learn

    def spy(**kw):
        calls.append(kw["network"])
        return rlearn(**kw)

    monkeypatch.setattr(ppo_recurrent, "learn", spy)
    env = make_discrete_identity_env(4, dim=3, device="cpu")
    path = str(tmp_path / "lstm.model")
    state = ppo.learn(env=env, network="lstm", nsteps=4, nminibatches=2,
                      noptepochs=1, total_timesteps=2 * 16, device="cpu",
                      save_path=path, network_kwargs=dict(num_hidden=8),
                      nlstm=8)
    assert calls == ["lstm"]
    assert isinstance(state, ppo_recurrent.RecurrentPPOState)
    assert state.update == 2 and state.adam.count == 2 * 2
    with pytest.raises(ValueError, match="make_recurrent_ppo"):
        ppo.make_ppo(env, network="cnn_lstm", device="cpu")
    # the saved policy reads in JAX's load_params and back
    from toybox_tpu.rl.test_envs import make_discrete_identity_env as jid
    jinit, _, _ = jrec.make_recurrent_ppo(
        jid(4, dim=3), network="lstm", nlstm=8, nsteps=4, nminibatches=2,
        network_kwargs=dict(num_hidden=8))
    loaded = jppo.load_params(path, jinit(0).params)
    back = params_from_flax(_np(loaded))
    for k, v in state.module.state_dict().items():
        assert torch.equal(back[k], v), k

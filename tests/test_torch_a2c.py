"""The port's A2C (toybox_tpu_torch.rl.a2c) against the JAX package's.

- One ``make_a2c`` update (cnn, Breakout, 2 envs x nsteps 8) and two
  consecutive ``make_recurrent_a2c`` updates (lstm, the fixed-sequence
  env, 4 envs x nsteps 8, episodes of 3 steps so the carry resets inside
  the rollout): the JAX ``train_step`` from ``init_fn(0)`` against the
  port's returns and update fed the JAX rollout, replayed here with JAX's
  key schedule (one split a step), and the JAX params carried across.
  Tolerance: params within 1e-6 absolute (as PPO's test; RMSProp's first
  step moves a param by up to 10 lr = 7e-3), metrics within 1e-5
  relative or 1e-7 absolute.
- The RMS chain against optax's over several steps.
- The identity (> 0.8) and fixed-sequence (> 0.6) learning tests,
  mirroring tests/test_rl_learning.py:39,402.
- ``learn``: whole blocks of updates_per_jit, the block metrics, the
  logger, the checkpointer and the saved file in JAX's ``load_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import a2c as ja2c
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl.distributions import CategoricalPd as JCategoricalPd
from toybox_tpu.rl.test_envs import make_discrete_identity_env as j_identity
from toybox_tpu.rl.test_envs import make_fixed_sequence_env as j_fixed_seq
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.rl import a2c, ppo
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.policies import build_policy
from toybox_tpu_torch.rl.ppo_recurrent import build_recurrent_policy
from toybox_tpu_torch.rl.test_envs import (make_discrete_identity_env,
                                           make_fixed_sequence_env)

NSTEPS, NENVS = 8, 2
PARAM_ATOL = 1e-6


def _closure(fn, name):
    for var, cell in zip(fn.__code__.co_freevars, fn.__closure__):
        if var == name:
            return cell.cell_contents
    raise KeyError(name)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params(got: dict, want_tree, before_tree=None):
    want = params_from_flax(_np(want_tree))
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    if before_tree is not None:
        before = params_from_flax(_np(before_tree))
        moved = max(float((want[k] - before[k]).abs().max()) for k in want)
        assert moved > 1e-4, f"the update moved the params by only {moved}"
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    return worst


def _assert_metrics(got: dict, want: dict, keys):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# make_a2c against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_breakout():
    env = j_make_rl_env("breakout", NENVS)
    init_fn, train_step = ja2c.make_a2c(env, network="cnn", nsteps=NSTEPS)
    p_step = _closure(train_step, "p_step")
    p_value = _closure(train_step, "p_value")
    state0 = init_fn(0)

    @jax.jit
    def replay(state):
        def body(carry, _):
            env_state, key = carry
            obs = env_state.frames
            key, akey = jax.random.split(key)
            actions, _, _, _ = p_step(state.params, obs, akey)
            env_state, _, rewards, dones, _ = env.step(env_state, actions)
            return (env_state, key), (obs, actions, rewards, dones)

        (env_state, _), (obs, actions, rewards, dones) = jax.lax.scan(
            body, (state.env_state, state.key), None, length=NSTEPS)
        return dict(obs=obs, actions=actions, rewards=rewards, dones=dones,
                    last_value=p_value(state.params, env_state.frames))

    inputs = _np(replay(state0))
    state1, metrics = jax.jit(train_step)(state0)
    return dict(state0=state0, state1=state1, inputs=inputs,
                metrics=_np(metrics))


def test_returns_match_jax_disc():
    r = np.random.default_rng(0)
    rewards = r.choice([0.0, 1.0, -1.0], size=(9, 5)).astype(np.float32)
    dones = r.random((9, 5)) < 0.2
    last = r.normal(size=5).astype(np.float32)

    def disc(next_ret, t):
        rr, d = t
        ret = rr + 0.99 * next_ret * (1.0 - d.astype(jnp.float32))
        return ret, ret

    _, want = jax.lax.scan(disc, jnp.asarray(last),
                           (jnp.asarray(rewards), jnp.asarray(dones)),
                           reverse=True)
    got = a2c.discounted_returns(torch.tensor(rewards), torch.tensor(dones),
                                 torch.tensor(last), 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_one_update_matches_jax_train_step(jax_breakout):
    x = {k: torch.tensor(v) for k, v in jax_breakout["inputs"].items()}
    tenv = t_make_rl_env("breakout", NENVS, device="cpu")
    module, _, _, _ = build_policy(tenv.obs_shape, tenv.num_actions, "cnn",
                                   device="cpu")
    module.load_state_dict(params_from_flax(
        _np(jax_breakout["state0"].params)))
    rms = ppo.RmsState.zeros_like(list(module.parameters()))
    returns = a2c.discounted_returns(x["rewards"], x["dones"],
                                     x["last_value"], 0.99)
    lrnow, _ = ppo.anneal(0, 1, 7e-4, 0.0)
    metrics = a2c.update(module, rms, x["obs"], x["actions"].long(),
                         returns, lrnow, a2c.Hyper(), tenv.num_actions)
    worst = _assert_params(module.state_dict(),
                           jax_breakout["state1"].params,
                           jax_breakout["state0"].params)
    print(f"port vs JAX max diff {worst:.3g}")
    _assert_metrics(metrics, jax_breakout["metrics"], a2c.METRICS)


# ---------------------------------------------------------------------------
# make_recurrent_a2c against JAX: two updates in a row
# ---------------------------------------------------------------------------

REC_ENVS, REC_LEN, NLSTM, HIDDEN = 4, 3, 16, 16


def _replay_recurrent(train_step, env, nsteps):
    """A jitted replay of the JAX recurrent rollout (the A2C and PPO
    train_steps share its key schedule)."""
    module = _closure(train_step, "module")

    @jax.jit
    def replay(state):
        def body(c, _):
            env_state, carry, prev_done, key = c
            obs = env_state.frames
            key, akey = jax.random.split(key)
            logits, values, new_carry = module.apply(state.params, obs,
                                                     carry, prev_done)
            pd = JCategoricalPd(logits)
            actions = pd.sample(akey)
            env_state, _, rewards, dones, _ = env.step(
                env_state, actions.astype(jnp.int32))
            return (env_state, new_carry, dones, key), (
                obs, actions, values, pd.neglogp(actions), rewards, dones,
                prev_done)

        (env_state, carry, prev_done, key), traj = jax.lax.scan(
            body, (state.env_state, state.carry, state.prev_done,
                   state.key), None, length=nsteps)
        _, last_value, _ = module.apply(state.params, env_state.frames,
                                        carry, prev_done)
        names = ("obs", "actions", "values", "neglogps", "rewards", "dones",
                 "prev_dones")
        return dict(zip(names, traj), last_value=last_value, key=key,
                    carry0=state.carry)

    return replay


def test_two_recurrent_updates_match_jax_train_step():
    env = j_fixed_seq(REC_ENVS, n_actions=3, episode_len=REC_LEN)
    init_fn, train_step = ja2c.make_recurrent_a2c(
        env, network="lstm", nlstm=NLSTM, nsteps=NSTEPS, lr=5e-3,
        gamma=0.5, total_updates=4,
        network_kwargs=dict(num_hidden=HIDDEN))
    replay = _replay_recurrent(train_step, env, NSTEPS)
    step = jax.jit(train_step)
    states = [init_fn(0)]
    inputs, metrics = [], []
    for _ in range(2):
        inputs.append(_np(replay(states[-1])))
        s, m = step(states[-1])
        states.append(s)
        metrics.append(_np(m))
    assert inputs[0]["prev_dones"].any()          # the carry resets
    assert np.abs(inputs[1]["carry0"][0]).max() > 0

    module, _ = build_recurrent_policy((1,), 3, "lstm", NLSTM, "cpu",
                                       dict(num_hidden=HIDDEN))
    module.load_state_dict(params_from_flax(_np(states[0].params)))
    rms = ppo.RmsState.zeros_like(list(module.parameters()))
    hp = a2c.Hyper()
    for u, x in enumerate(inputs):
        t = {k: torch.tensor(v) for k, v in x.items()
             if k not in ("key", "carry0")}
        returns = a2c.discounted_returns(t["rewards"], t["dones"],
                                         t["last_value"], 0.5)
        carry0 = tuple(torch.tensor(c) for c in x["carry0"])
        lrnow, _ = ppo.anneal(u, 4, 5e-3, 0.0)
        m = a2c.recurrent_update(module, rms, t["obs"], t["actions"].long(),
                                 returns, t["prev_dones"], carry0, lrnow, hp,
                                 3)
        _assert_params(module.state_dict(), states[u + 1].params,
                       states[u].params)
        _assert_metrics(m, metrics[u], a2c.METRICS)


# ---------------------------------------------------------------------------
# The optimizer, learning, learn()
# ---------------------------------------------------------------------------

def test_rms_chain_matches_optax_steps():
    """clip_by_global_norm -> scale_by_rms(decay .99, eps 1e-5) ->
    scale(-1), times lr after it, on the same gradients as optax: four
    steps, one clipped, some gradients far under sqrt(eps)."""
    import optax
    r = np.random.default_rng(2)
    params = [r.normal(size=(3, 4)).astype(np.float32),
              r.normal(size=(4,)).astype(np.float32)]
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.scale_by_rms(decay=0.99, eps=1e-5),
                     optax.scale(-1.0))
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.as_tensor(p.copy()) for p in params]
    rms = ppo.RmsState.zeros_like(tp)
    for i, scale in enumerate((0.01, 3.0, 1e-4, 0.1)):
        lrnow = float(np.float32(7e-4) * np.float32(1 - i / 8))
        grads = [(r.normal(size=p.shape) * scale).astype(np.float32)
                 for p in params]
        u, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = [p + v * lrnow for p, v in zip(jp, u)]
        g = ppo.clip_by_global_norm([torch.as_tensor(g) for g in grads],
                                    0.5)
        ppo.rms_update(tp, g, rms, lrnow)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-8, err_msg=f"step {i}")
    # torch.optim.RMSprop's sqrt(nu) + eps takes another first step
    p = torch.zeros(1, requires_grad=True)
    opt = torch.optim.RMSprop([p], lr=1.0, alpha=0.99, eps=1e-5)
    p.grad = torch.full((1,), 1e-4)
    opt.step()
    q = [torch.zeros(1)]
    ppo.rms_update(q, [torch.full((1,), 1e-4)], ppo.RmsState.zeros_like(q),
                   1.0)
    assert abs(float(p.detach()) - float(q[0])) > 1e-3


def test_a2c_learns_identity():
    """tests/test_rl_learning.py:39-48 in the port."""
    env = make_discrete_identity_env(16, dim=4, device="cpu")
    init_fn, step = a2c.make_a2c(env, network="mlp", nsteps=8, lr=1e-2,
                                 gamma=0.1, total_updates=5000,
                                 network_kwargs=dict(num_hidden=32),
                                 device="cpu")
    state = init_fn(0)
    for _ in range(500):
        state, metrics = step(state)
    r = float(metrics["mean_reward"])
    assert r > 0.8, f"a2c failed to learn identity: {r}"


def test_recurrent_a2c_learns_fixed_sequence():
    """tests/test_rl_learning.py:402-418 in the port."""
    env = make_fixed_sequence_env(16, n_actions=3, episode_len=8,
                                  device="cpu")
    init_fn, step = a2c.make_recurrent_a2c(
        env, network="lstm", nlstm=32, nsteps=8, lr=5e-3, gamma=0.5,
        ent_coef=0.01, total_updates=4000,
        network_kwargs=dict(num_hidden=32), device="cpu")
    state = init_fn(0)
    for _ in range(400):
        state, metrics = step(state)
    r = float(metrics["mean_reward"])
    assert r > 0.6, f"recurrent a2c failed to memorize the sequence: {r}"


class _Rows:
    def __init__(self):
        self.rows, self.row = [], {}

    def logkv(self, k, v):
        self.row[k] = v

    def dumpkvs(self):
        self.rows.append(self.row)
        self.row = {}


@pytest.mark.parametrize("network", ["mlp", "lstm"])
def test_learn_runs_whole_blocks_as_jax(network, tmp_path):
    """total 7 updates in blocks of 3: the JAX range runs 2 blocks (6
    updates); the logged row is each block's last update with eprewmean
    the nanmean and episodes the sum over the block."""
    env = make_discrete_identity_env(4, dim=3, episode_len=5, device="cpu")
    log = _Rows()
    kw = dict(num_hidden=8)
    state = a2c.learn(env=env, network=network, nsteps=4,
                      total_timesteps=7 * 16, updates_per_jit=3,
                      log_interval=3, logger=log, network_kwargs=kw,
                      nlstm=8, device="cpu",
                      save_path=str(tmp_path / "m.model"))
    assert state.update == 6 == 3 * len(range(3, 8, 3))
    assert [r["nupdates"] for r in log.rows] == [3, 6]
    # 4 envs x 12 steps a block, episodes of 5 steps: each env ends 2 in
    # a block (steps 5, 10; 15, 20), at most 1 in an update of 4 steps
    assert [r["episodes"] for r in log.rows] == [8.0, 8.0]
    assert all(np.isfinite(r["eprewmean"]) for r in log.rows)
    assert set(log.rows[0]) >= set(a2c.METRICS) | {"fps", "mean_reward"}
    # the saved policy reads in JAX's load_params
    maker = ja2c.make_recurrent_a2c if network == "lstm" else ja2c.make_a2c
    jinit, _ = maker(j_identity(4, dim=3), network=network,
                     network_kwargs=kw,
                     **(dict(nlstm=8) if network == "lstm" else {}))
    template = jinit(0).params
    loaded = jppo.load_params(str(tmp_path / "m.model"), template)
    back = params_from_flax(_np(loaded))
    for k, v in state.module.state_dict().items():
        assert torch.equal(back[k], v), k


def test_learn_checkpoints_and_resumes(tmp_path):
    env = make_discrete_identity_env(4, dim=3, device="cpu")
    kw = dict(env=env, network="mlp", nsteps=4, device="cpu",
              checkpoint_path=str(tmp_path), checkpoint_freq=2,
              updates_per_jit=2, network_kwargs=dict(num_hidden=8))
    s4 = a2c.learn(total_timesteps=4 * 16, **kw)
    env2 = make_discrete_identity_env(4, dim=3, device="cpu")
    s6 = a2c.learn(total_timesteps=6 * 16, **dict(kw, env=env2))
    assert s4.update == 4 and s6.update == 6
    assert float(s6.rms.nu[0].abs().sum()) > 0

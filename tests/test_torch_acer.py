"""The port's ACER (toybox_tpu_torch.rl.acer) against the JAX package's.

- ``acer_losses`` against JAX's ``_acer_losses`` on seeded random inputs,
  with and without the trust region (and with a delta small enough that
  the projection acts): the loss within 1e-5 relative, its gradients with
  respect to the logits (through pi = softmax(logits) too) and to Q
  within 1e-6 absolute.
- Two ``make_acer`` cycles (cnn_small, Breakout, 2 envs x nsteps 8,
  replay_ratio 2; the second cycle replays) and two recurrent cycles
  (lstm, the fixed-sequence env, 4 envs x nsteps 8, episodes of 3 steps
  so the carry resets inside the rollout) against the JAX ``cycle`` from
  ``init_fn(0)``: the JAX cycle's draws (its actions' Gumbel noise and
  the replay indices) are replayed here with its key schedule and fed to
  the port's cycle (``draws=``), and ``playback_env`` (from
  tests/test_torch_dqn.py) plays back the trajectories JAX stored in its
  ring. Compared: params, the average params and the
  RMS moments within 1e-6 absolute (a chain of 1 + replay_ratio RMSProp
  steps, as A2C's test holds one), the ring's contents exactly but for
  the behaviour probabilities (1e-6), the carry, and the metrics within
  1e-5 relative or 1e-6 absolute.
- (The identity and fixed-sequence learning tests:
  tests/test_torch_replay_learning.py.)
- ``learn``: whole blocks of cycles_per_jit, eprewmean the nanmean over
  a block, and the saved file in JAX's ``load_params`` (cnn_small and
  lstm), and ``run.main --alg=acer`` with both networks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_dqn import (_Rows, _assert_close, _assert_named,
                                  _np, _t, playback_env)
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import acer as jacer
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl.test_envs import make_discrete_identity_env as j_identity
from toybox_tpu.rl.test_envs import make_fixed_sequence_env as j_fixed_seq
from toybox_tpu_torch import run
from toybox_tpu_torch.rl import acer
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.eval_adapter import load_eval_params
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env

# ---------------------------------------------------------------------------
# The losses
# ---------------------------------------------------------------------------


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("trust_region,delta", [(False, 1.0), (True, 1.0),
                                                (True, 0.001)])
def test_acer_losses_match_jax(trust_region, delta):
    r = np.random.default_rng(7)
    T, N, A = 6, 3, 4
    logits = r.normal(size=(T + 1, N, A)).astype(np.float32)
    q = r.normal(size=(T + 1, N, A)).astype(np.float32)
    pi_avg = _softmax(r.normal(size=(T + 1, N, A)).astype(np.float32))
    mus = _softmax(2 * r.normal(size=(T, N, A)).astype(np.float32))
    actions = r.integers(0, A, (T, N)).astype(np.int32)
    rewards = r.choice([0.0, 1.0, -1.0], (T, N)).astype(np.float32)
    dones = r.random((T, N)) < 0.25
    kw = dict(gamma=0.9, c=1.5, delta=delta, ent_coef=0.01, q_coef=0.5,
              trust_region=trust_region)

    def jloss(lg, qq, delta=delta):
        return jacer._acer_losses(jax.nn.softmax(lg, -1), lg, qq,
                                  jnp.asarray(pi_avg), jnp.asarray(actions),
                                  jnp.asarray(rewards), jnp.asarray(mus),
                                  jnp.asarray(dones), **dict(kw, delta=delta))

    def jgrads(delta):
        return jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(logits), jnp.asarray(q), delta)

    (jl, jm), (jgl, jgq) = jgrads(delta)
    lg = torch.tensor(logits, requires_grad=True)
    qq = torch.tensor(q, requires_grad=True)
    loss, m = acer.acer_losses(torch.softmax(lg, -1), lg, qq, _t(pi_avg),
                               _t(actions), _t(rewards), _t(mus), _t(dones),
                               **kw)
    gl, gq = torch.autograd.grad(loss, (lg, qq))
    _assert_close(loss.detach(), jl, "loss")
    for k in acer.METRICS:
        _assert_close(m[k], jm[k], k)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gq.numpy(), np.asarray(jgq), rtol=0,
                               atol=1e-6)
    assert float(jnp.abs(jgl).max()) > 1e-3
    if trust_region and delta < 0.01:
        # the projection acts: with a delta it never reaches, the
        # gradient on the logits differs
        _, (plain, _) = jgrads(1e9)
        assert float(jnp.abs(plain - jgl).max()) > 1e-4


def test_retrace_matches_jax_scan():
    r = np.random.default_rng(3)
    T, N = 7, 4
    x = [r.normal(size=(T, N)).astype(np.float32) for _ in range(4)]
    rewards, q_a, v, rho = x[0], x[1], x[2], np.abs(x[3]) * 2
    dones = r.random((T, N)) < 0.3
    last = r.normal(size=N).astype(np.float32)

    def body(nxt, t):
        rr, d, qa, vv, ra = t
        qret = rr + 0.99 * nxt * (1.0 - d.astype(jnp.float32))
        return jnp.minimum(1.0, ra) * (qret - qa) + vv, qret

    _, want = jax.lax.scan(body, jnp.asarray(last), tuple(map(
        jnp.asarray, (rewards, dones, q_a, v, rho))), reverse=True)
    got = acer.retrace(_t(rewards), _t(dones), _t(q_a), _t(v), _t(rho),
                       _t(last), 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Cycles against JAX
# ---------------------------------------------------------------------------

NSTEPS, RATIO, CAP = 8, 2, 4


def _jax_draws(n_envs, n_actions):
    """A jitted replay of one JAX cycle's draws with its key schedule: a
    split a step (the actions' Gumbel noise), then replay_ratio + 1 (the
    replay indices, below the ring's size after the store). Env-free: the
    frames come from JAX's ring."""

    @jax.jit
    def draws(state):
        def body(key, _):
            key, akey = jax.random.split(key)
            return key, jax.random.gumbel(akey, (n_envs, n_actions))

        key, g = jax.lax.scan(body, state.key, None, length=NSTEPS)
        size = jnp.minimum(state.replay.size + 1, CAP)
        key, *rkeys = jax.random.split(key, RATIO + 1)
        idx = jnp.stack([jax.random.randint(k, (), 0, jnp.maximum(size, 1))
                         for k in rkeys])
        return dict(gumbel=g, replay_idx=idx)

    return draws


def _rms_nu(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByRmsState))
        if isinstance(s, optax.ScaleByRmsState)).nu


def _run_cycles(jenv, network, ep_ret_of, n_cycles=2, **kw):
    """JAX's cycles from init_fn(0) and the port's fed their draws and the
    trajectories JAX stored in its ring (the episode returns, which the
    ring does not keep, from ``ep_ret_of(dones)``), compared after
    each."""
    recurrent = network == "lstm"
    maker = jacer.make_recurrent_acer if recurrent else jacer.make_acer
    init_fn, cycle = maker(jenv, network=network, nsteps=NSTEPS,
                           replay_ratio=RATIO, buffer_traj=CAP, **kw)
    replay = _jax_draws(jenv.num_envs, jenv.num_actions)
    step = jax.jit(cycle)
    states, draws, metrics = [jax.jit(init_fn, static_argnums=0)(0)], [], []
    for _ in range(n_cycles):
        draws.append(_np(replay(states[-1])))
        s, m = step(states[-1])
        states.append(s)
        metrics.append(_np(m))
    rb = _np(states[-1].replay)
    frames = np.concatenate([rb.obs[0]] + [rb.obs[c, 1:]
                                           for c in range(1, n_cycles)])
    rewards, dones = (x[:n_cycles].reshape((-1,) + x.shape[2:])
                      for x in (rb.rewards, rb.dones))
    env = playback_env(frames, rewards, dones, ep_ret_of(dones),
                       jenv.num_actions)
    tinit, tcycle = acer.make_acer(env, network=network, nsteps=NSTEPS,
                                   replay_ratio=RATIO, buffer_traj=CAP,
                                   device="cpu", **kw)
    st = tinit(0)
    st.module.load_state_dict(params_from_flax(_np(states[0].params)))
    st.avg.load_state_dict(st.module.state_dict())
    names = [n for n, _ in st.module.named_parameters()]
    for c, d in enumerate(draws):
        collected = tcycle.collect(st, {"gumbel": _t(d["gumbel"])})
        st, m = tcycle.optimize(st, collected,
                                {"replay_idx": _t(d["replay_idx"]).long()})
        want = states[c + 1]
        _assert_named(st.module.state_dict(), want.params, f"{c} params")
        _assert_named(st.avg.state_dict(), want.avg_params, f"{c} avg")
        _assert_named(dict(zip(names, st.rms.nu)), _rms_nu(want.opt_state),
                      f"{c} nu")
        jrb, rb = want.replay, st.replay
        assert (rb.cursor, rb.size) == (int(jrb.cursor), int(jrb.size))
        fields = ("obs", "actions", "rewards", "dones") + (
            ("masks",) if recurrent else ())
        for k in fields:
            np.testing.assert_array_equal(getattr(rb, k).numpy(),
                                          np.asarray(getattr(jrb, k)),
                                          err_msg=f"cycle {c} {k}")
        np.testing.assert_allclose(rb.mus.numpy(), np.asarray(jrb.mus),
                                   rtol=0, atol=1e-6)
        if recurrent:
            for a, b in zip(st.carry, want.carry):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=1e-6)
            np.testing.assert_array_equal(st.prev_done.numpy(),
                                          np.asarray(want.prev_done))
        assert set(m) == set(metrics[c])
        for k, v in metrics[c].items():
            _assert_close(m[k], v, f"cycle {c} {k}")
    return states, draws, st


def _no_episode_end(dones):
    return np.full(dones.shape, np.nan, np.float32)


def test_two_cycles_match_jax_breakout():
    """16 agent steps end no Breakout game (5 lives): every episode
    return is NaN, as JAX's eprewmean shows."""
    states, draws, st = _run_cycles(j_make_rl_env("breakout", 2),
                                    "cnn_small", _no_episode_end)
    # the first cycle stores one trajectory and does not replay; the
    # second replays
    assert int(states[1].replay.size) == 1 and st.replay.size == 2
    assert st.update == 2


def test_two_recurrent_cycles_match_jax():
    env = j_fixed_seq(4, n_actions=3, episode_len=3)

    def ep_ret(dones):            # the fixed-sequence env's: 0 at the end
        return np.where(dones, 0.0, np.nan).astype(np.float32)

    states, draws, st = _run_cycles(env, "lstm", ep_ret, nlstm=16, lr=5e-3,
                                    gamma=0.5,
                                    network_kwargs=dict(num_hidden=16))
    assert np.asarray(states[2].replay.dones).any()   # the carry resets
    assert np.asarray(states[2].replay.masks).any()


# ---------------------------------------------------------------------------
# Learning, learn(), the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("network", ["mlp", "lstm"])
def test_learn_runs_whole_blocks_as_jax(network, tmp_path):
    """total 7 cycles of 4 envs x 4 steps in blocks of 3: JAX's range runs
    2 blocks; eprewmean is the nanmean over the block (episodes of 5
    steps end in every block); the saved policy reads in JAX."""
    log = _Rows()
    kw = dict(num_hidden=8)
    path = str(tmp_path / "m.model")
    state = acer.learn(env=make_discrete_identity_env(4, dim=3,
                                                      episode_len=5,
                                                      device="cpu"),
                       network=network, nsteps=4, total_timesteps=7 * 16,
                       cycles_per_jit=3, log_interval=3, logger=log,
                       network_kwargs=kw, nlstm=8, buffer_traj=4,
                       device="cpu", save_path=path)
    assert state.update == 6
    assert [r["nupdates"] for r in log.rows] == [3, 6]
    assert set(log.rows[0]) == {"nupdates", "fps", "eprewmean",
                                "mean_reward", *acer.METRICS}
    assert all(np.isfinite(r["eprewmean"]) for r in log.rows)
    jenv = j_identity(4, dim=3)
    if network == "lstm":
        jinit, _ = jacer.make_recurrent_acer(jenv, network="lstm", nlstm=8,
                                             network_kwargs=kw)
    else:
        jinit, _ = jacer.make_acer(jenv, network="mlp", network_kwargs=kw)
    template = jax.jit(jinit, static_argnums=0)(0).params
    back = params_from_flax(_np(jppo.load_params(path, template)))
    for k, v in state.module.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("network", ["cnn_small", "cnn_lstm"])
def test_run_main_trains_and_saves_acer(network, tmp_path):
    path = str(tmp_path / "acer.model")
    state = run.main(["--alg=acer", f"--network={network}",
                      "--env=BreakoutToyboxNoFrameskip-v4", "--num_envs=2",
                      "--nsteps=4", "--cycles_per_jit=2",
                      "--num_timesteps=64", "--device=cpu",
                      f"--save_path={path}",
                      f"--log_path={tmp_path / 'log'}"])
    assert state.update == 2 and state.replay.size == 2
    head = load_eval_params("acer", network, path, "breakout", device="cpu")
    for k, v in state.module.state_dict().items():
        assert torch.equal(head.state_dict()[k], v), k

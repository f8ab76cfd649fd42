"""The port's PPO1 (toybox_tpu_torch.rl.ppo1) against the JAX package's.

- ``ObFilter.update`` and ``normalize`` against JAX's on seeded batches
  (two merges), within 1e-6 relative.
- One update against JAX's ``train_step`` from ``init_fn(0)``, the JAX
  params carried across: JAX's rollout is replayed here with its key
  schedule (a split a step, the actions ``argmax(logits + gumbel)``, then
  the epochs' keys and permutations), its frames played back to the
  port's update (``playback_env``) and its Gumbel noise and permutations
  fed in (``draws=``). Compared: the actions, params, old params, the
  Adam moments and count, the filter, beta and the metrics. Run with mlp,
  the observation filter and the adaptive KL penalty on the identity env
  (4 envs x 8 steps, minibatches of 8, 2 epochs), and with cnn_small on a
  2-env Breakout pipeline (nsteps 8, minibatches of 8, 2 epochs) over two
  updates under the linear schedule (lrmult 1, then 0.5). Tolerance:
  params, old params and moments within 1e-6 absolute, as PPO's; the
  filter, beta and the metrics within 1e-5 relative or 1e-6 absolute.
- The learning tests of tests/test_rl_learning.py:248-295 at JAX's
  thresholds (the port's identity env, its own draws).
- (``run.main --alg=ppo1``: tests/test_torch_learners_cli.py.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_dqn import _assert_close, _assert_named, _np, _t
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import ppo1 as jppo1
from toybox_tpu.rl.test_envs import make_discrete_identity_env as j_identity
from toybox_tpu_torch.envs.batched import BatchedEnvFns
from toybox_tpu_torch.rl import ppo1
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env


def _closure(fn, name):
    for var, cell in zip(fn.__code__.co_freevars, fn.__closure__):
        if var == name:
            return cell.cell_contents
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class PlaybackState:
    frames: torch.Tensor
    t: int


def playback_env(run: dict, num_actions: int, frames_per_step=4):
    """A BatchedEnvFns playing a recorded run back whatever the actions:
    reset gives frames[0]; step t gives frames[t + 1], rewards[t],
    dones[t], ep_ret[t] and ep_len[t] (the caller compares the
    actions)."""
    frames, rewards, dones, ep_ret, ep_len = (
        _t(run[k]) for k in ("frames", "rewards", "dones", "ep_ret",
                             "ep_len"))

    def reset(seeds):
        return PlaybackState(frames[0], 0), frames[0]

    def step(st, actions):
        t = st.t
        nxt = PlaybackState(frames[t + 1], t + 1)
        info = {"episode_return": ep_ret[t],
                "episode_length": ep_len[t].to(torch.int32),
                "raw_reward": rewards[t]}
        return nxt, nxt.frames, rewards[t], dones[t], info

    return BatchedEnvFns(game_name="playback", num_envs=frames.shape[1],
                         obs_mode="playback", reset=reset, step=step,
                         obs_shape=tuple(frames.shape[2:]),
                         num_actions=num_actions,
                         legal_actions=tuple(range(num_actions)),
                         frames_per_step=frames_per_step)


def _concat_runs(runs: list) -> dict:
    """Runs recorded one after another as one run."""
    out = {k: np.concatenate([r[k] for r in runs]) for k in
           ("rewards", "dones", "ep_ret", "ep_len", "actions", "gumbel")}
    out["frames"] = np.concatenate([r["frames"][:-1] for r in runs]
                                   + [runs[-1]["frames"][-1:]])
    return out


def test_ob_filter_matches_jax():
    r = np.random.default_rng(0)
    jf, tf = jppo1.ObFilter.create((3, 5)), ppo1.ObFilter.create((3, 5),
                                                                 "cpu")
    for n in (7, 32):
        batch = (3 * r.normal(size=(n, 3, 5)) + 2).astype(np.float32)
        jf, tf = jf.update(jnp.asarray(batch)), tf.update(_t(batch))
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(tf, k).numpy(),
                                       np.asarray(getattr(jf, k)),
                                       rtol=1e-6, err_msg=k)
        obs = (6 * r.normal(size=(9, 3, 5))).astype(np.float32)
        np.testing.assert_allclose(tf.normalize(_t(obs)).numpy(),
                                   np.asarray(jf.normalize(obs)),
                                   rtol=1e-6, atol=1e-6)
    assert float(tf.normalize(_t(np.full((1, 3, 5), 1e6, np.float32)))
                 .max()) == 5.0


def _jax_update(env, nsteps, epochs, batchsize, n_updates, **kw):
    """JAX's make_ppo1 from init_fn(0): the states after each train_step,
    the metrics, and each update's run replayed with its key schedule
    (frames, rewards, dones, episode returns and lengths, actions, the
    Gumbel noise, the epochs' permutations)."""
    init_fn, train_step = jppo1.make_ppo1(
        env, timesteps_per_actorbatch=nsteps, optim_epochs=epochs,
        optim_batchsize=batchsize, **kw)
    apply = _closure(train_step, "_apply")
    nbatch = env.num_envs * nsteps

    @jax.jit
    def replay(state):
        def body(carry, _):
            env_state, key = carry
            obs = env_state.frames
            key, akey = jax.random.split(key)
            logits, _ = apply(state.params, state.ob_rms, obs)
            g = jax.random.gumbel(akey, logits.shape, jnp.float32)
            actions = jnp.argmax(logits + g, axis=-1)
            env_state, _, rewards, dones, info = env.step(env_state,
                                                          actions)
            return (env_state, key), (obs, rewards, dones,
                                      info["episode_return"],
                                      info["episode_length"], actions, g)

        (env_state, key), traj = jax.lax.scan(
            body, (state.env_state, state.key), None, length=nsteps)
        key, *ekeys = jax.random.split(key, epochs + 1)
        perms = jnp.stack([jax.random.permutation(k, nbatch)
                           for k in ekeys])
        return traj, env_state.frames, perms

    step = jax.jit(train_step)
    states, runs, metrics = [jax.jit(init_fn, static_argnums=0)(0)], [], []
    for _ in range(n_updates):
        traj, last, perms = _np(replay(states[-1]))
        obs, rewards, dones, ep_ret, ep_len, actions, g = traj
        s, m = step(states[-1])
        np.testing.assert_array_equal(np.asarray(s.env_state.frames), last)
        states.append(s)
        metrics.append(_np(m))
        runs.append(dict(frames=np.concatenate([obs, last[None]]),
                         rewards=rewards, dones=dones, ep_ret=ep_ret,
                         ep_len=ep_len, actions=actions, gumbel=g,
                         perms=perms))
    return states, runs, metrics


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _compare_updates(jenv, n_updates, nsteps=8, epochs=2, batchsize=8,
                     **kw):
    states, runs, metrics = _jax_update(jenv, nsteps, epochs, batchsize,
                                        n_updates, **kw)
    env = playback_env(_concat_runs(runs), jenv.num_actions,
                       getattr(jenv, "frames_per_step", 1))
    init_fn, step = ppo1.make_ppo1(
        env, timesteps_per_actorbatch=nsteps, optim_epochs=epochs,
        optim_batchsize=batchsize, device="cpu", **kw)
    st = init_fn(0)
    st.module.load_state_dict(params_from_flax(_np(states[0].params)))
    names = [n for n, _ in st.module.named_parameters()]
    for u, run in enumerate(runs):
        collected = step.collect(st, {"gumbel": _t(run["gumbel"])})
        np.testing.assert_array_equal(collected[1].actions.numpy(),
                                      run["actions"], err_msg=f"update {u}")
        st, m = step.optimize(st, collected, {"perms": _t(run["perms"])})
        want = states[u + 1]
        _assert_named(st.module.state_dict(), want.params, f"{u} params")
        _assert_named(st.old.state_dict(), want.old_params, f"{u} old")
        adam = _adam(want.opt_state)
        assert st.adam.count == int(adam.count) == (u + 1) * epochs * (
            nsteps * jenv.num_envs // batchsize)
        for what, got in (("mu", st.adam.mu), ("nu", st.adam.nu)):
            _assert_named(dict(zip(names, got)), getattr(adam, what),
                          f"{u} {what}")
        for k in ("mean", "var", "count"):
            _assert_close(getattr(st.ob_rms, k), getattr(want.ob_rms, k),
                          f"{u} ob_rms {k}")
        _assert_close(st.kl_beta, want.kl_beta, f"{u} kl_beta")
        assert st.update == int(want.update) == u + 1
        assert set(m) == set(metrics[u])
        for k, v in metrics[u].items():
            _assert_close(m[k], v, f"{u} {k}")
    return states


def test_mlp_update_with_filter_and_kl_matches_jax():
    states = _compare_updates(
        j_identity(4, dim=3, episode_len=5), 1, network="mlp",
        kl_targ=1e-4, entcoeff=0.01, optim_stepsize=1e-2,
        network_kwargs=dict(num_hidden=16))
    # the filter and beta moved: the comparison saw them
    assert float(states[1].ob_rms.count) > 1.0
    assert float(states[1].kl_beta) != 1.0


def test_cnn_small_updates_with_linear_schedule_match_jax():
    _compare_updates(j_make_rl_env("breakout", 2), 2, network="cnn_small",
                     schedule="linear", total_updates=2)


def test_ppo1_learns_identity():
    """tests/test_rl_learning.py:248-260 in the port."""
    env = make_discrete_identity_env(16, dim=4, device="cpu")
    init_fn, step = ppo1.make_ppo1(
        env, network="mlp", timesteps_per_actorbatch=16,
        optim_batchsize=64, optim_epochs=2, optim_stepsize=1e-2,
        clip_param=0.2, entcoeff=0.0, schedule="constant", gamma=0.1,
        total_updates=60, network_kwargs=dict(num_hidden=32), device="cpu")
    state = init_fn(0)
    for _ in range(60):
        state, metrics = step(state)
    r = float(metrics["mean_reward"])
    assert r > 0.8, f"ppo1 failed to learn identity: {r}"


def test_ppo1_adaptive_kl_learns_identity():
    """tests/test_rl_learning.py:263-283 in the port."""
    env = make_discrete_identity_env(16, dim=4, device="cpu")
    init_fn, step = ppo1.make_ppo1(
        env, network="mlp", timesteps_per_actorbatch=16,
        optim_batchsize=64, optim_epochs=2, optim_stepsize=1e-2,
        clip_param=0.2, entcoeff=0.0, schedule="constant", kl_targ=0.01,
        gamma=0.1, total_updates=80, network_kwargs=dict(num_hidden=32),
        device="cpu")
    state = init_fn(0)
    betas = []
    for _ in range(80):
        state, metrics = step(state)
        betas.append(float(state.kl_beta))
    assert float(metrics["mean_reward"]) > 0.8
    assert len(set(betas)) > 1, "kl_beta never adapted"


def test_ppo1_ob_filter_updates():
    """tests/test_rl_learning.py:286-295 in the port."""
    env = make_discrete_identity_env(8, dim=4, device="cpu")
    init_fn, step = ppo1.make_ppo1(
        env, network="mlp", timesteps_per_actorbatch=8,
        normalize_observations=True, total_updates=3,
        network_kwargs=dict(num_hidden=16), device="cpu")
    state = init_fn(0)
    c0 = float(state.ob_rms.count)
    state, _ = step(state)
    assert float(state.ob_rms.count) > c0, "ob_rms not updated"


@pytest.mark.parametrize("schedule,want", [("constant", [1.0, 1.0, 1.0]),
                                           ("linear", [1.0, 0.5, 0.0])])
def test_lrmult(schedule, want):
    assert [ppo1.lrmult(schedule, u, 2) for u in range(3)] == want
    with pytest.raises(NotImplementedError):
        ppo1.lrmult("cosine", 0, 2)

"""The port's DQN (toybox_tpu_torch.rl.dqn) against the JAX package's.

- The replay ring and its priorities (tests/test_rl.py:118-133 in the
  port), and ``replay_sample`` against JAX's fed the same Gumbel noise:
  the indices equal, the importance weights within 1e-6.
- Cycles of ``make_dqn`` (cnn_small on Gridworld, 2 envs, train_freq 2,
  a ring of 256, batches of 16) against the JAX ``cycle`` from
  ``init_fn(0)``, the JAX params carried across: three cycles that cross
  ``learning_starts`` (the first Adam step is the second cycle's) and a
  target sync (the third's), and two with parameter noise. The JAX
  cycle's draws are replayed here with its key schedule and fed to the
  port's cycle (``draws=``), and an env (``playback_env``) plays back the
  frames, rewards and dones that JAX's cycles wrote into their ring.
  Compared: params, target params, the Adam moments and count, the
  ring's contents and priorities, the noise scale and the metrics.
  Tolerance: params and
  moments within 1e-6 absolute, as PPO's test; priorities, the noise
  scale and the metrics within 1e-5 relative or 1e-6 absolute.
- QNetwork and its templates: tests/test_torch_q_templates.py; the
  learning tests: tests/test_torch_replay_learning.py.
- ``learn``: whole blocks of jit_cycles, the checkpointer's resume, the
  saved file in JAX's ``load_params``; ``run.main --alg=deepq --play``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import dqn as jdqn
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl.models import get_network_builder
from toybox_tpu_torch import run
from toybox_tpu_torch.envs.batched import BatchedEnvFns
from toybox_tpu_torch.rl import dqn
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.distributions import gumbel
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env

PARAM_ATOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_named(got: dict, want_tree, what, atol=PARAM_ATOL):
    want = params_from_flax(_np(want_tree))
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=atol, err_msg=f"{what} {k}")


def _assert_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-5,
                               atol=1e-6, err_msg=what)


@dataclasses.dataclass(frozen=True)
class PlaybackState:
    frames: torch.Tensor
    t: int


def playback_env(frames, rewards, dones, ep_ret, num_actions,
                 frames_per_step=4):
    """A BatchedEnvFns that plays a recorded run back: reset gives
    frames[0], step t gives frames[t + 1], rewards[t], dones[t] and
    ep_ret[t] whatever the actions (the caller compares the actions)."""
    frames, rewards, dones, ep_ret = map(_t, (frames, rewards, dones, ep_ret))

    def reset(seeds):
        return PlaybackState(frames[0], 0), frames[0]

    def step(st, actions):
        t = st.t
        nxt = PlaybackState(frames[t + 1], t + 1)
        info = {"episode_return": ep_ret[t],
                "episode_length": torch.zeros(frames.shape[1],
                                              dtype=torch.int32),
                "raw_reward": rewards[t]}
        return nxt, nxt.frames, rewards[t], dones[t], info

    return BatchedEnvFns(game_name="playback", num_envs=frames.shape[1],
                         obs_mode="playback", reset=reset, step=step,
                         obs_shape=tuple(frames.shape[2:]),
                         num_actions=num_actions,
                         legal_actions=tuple(range(num_actions)),
                         frames_per_step=frames_per_step)


# ---------------------------------------------------------------------------
# The ring and the sampler
# ---------------------------------------------------------------------------

def test_replay_ring_and_priorities():
    """tests/test_rl.py:118-133 in the port, and the priorities kept."""
    rb = dqn.make_replay(8, (2, 2, 1), device="cpu")
    obs = torch.ones((4, 2, 2, 1), dtype=torch.uint8)
    dqn.replay_add(rb, obs, obs * 2, torch.arange(4), torch.ones(4),
                   torch.zeros(4, dtype=torch.bool))
    assert rb.size == 4 and rb.cursor == 4
    assert torch.equal(rb.priorities[:4], torch.ones(4))
    rb.priorities[1] = 3.0
    dqn.replay_add(rb, obs, obs, torch.arange(4), torch.ones(4),
                   torch.zeros(4, dtype=torch.bool))
    dqn.replay_add(rb, obs, obs, torch.arange(4), torch.ones(4),
                   torch.zeros(4, dtype=torch.bool))
    assert rb.size == 8 and rb.cursor == 4              # wrapped
    assert torch.equal(rb.priorities, torch.full((8,), 3.0))
    noise = gumbel((16, 8), torch.Generator().manual_seed(0), "cpu")
    batch, idx, w = dqn.replay_sample(rb, noise, 0.6, 0.4)
    assert batch[0].shape == (16, 2, 2, 1)
    assert bool((idx < 8).all()) and bool((w <= 1.0 + 1e-6).all())


@pytest.mark.parametrize("size", [37, 64])
def test_replay_sample_matches_jax(size):
    cap, n_batch = 64, 32
    r = np.random.default_rng(size)
    jrb = jdqn.make_replay(cap, (2, 2, 1))
    obs = r.integers(0, 255, (cap, 2, 2, 1), dtype=np.uint8)
    prio = np.where(np.arange(cap) < size,
                    r.exponential(1.0, cap) + 1e-6, 0.0).astype(np.float32)
    jrb = jrb.replace(obs=jnp.asarray(obs), next_obs=jnp.asarray(obs[::-1]),
                      actions=jnp.arange(cap, dtype=jnp.int32),
                      priorities=jnp.asarray(prio),
                      size=jnp.asarray(size, jnp.int32))
    key = jax.random.PRNGKey(size)
    (jobs, jact, *_), jidx, jw = jdqn.replay_sample(jrb, key, n_batch, 0.6,
                                                    0.55)
    noise = _t(jax.random.gumbel(key, (n_batch, cap)))
    rb = dqn.make_replay(cap, (2, 2, 1), device="cpu")
    rb.obs[:], rb.next_obs[:] = _t(obs), _t(obs[::-1].copy())
    rb.actions[:] = torch.arange(cap)
    rb.priorities[:] = _t(prio)
    rb.size = size
    (obs_b, act_b, *_), idx, w = dqn.replay_sample(rb, noise, 0.6, 0.55)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(idx.max()) < size
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(obs_b.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(act_b.numpy(), np.asarray(jact))


# ---------------------------------------------------------------------------
# Cycles against JAX
# ---------------------------------------------------------------------------

NENVS, TRAIN_FREQ, CAP, BATCH = 2, 2, 256, 16


def _jax_noise(params, key):
    """The per-leaf normal draws of JAX's ``_perturb(params, key, s)``."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        jax.random.normal(k, p.shape, p.dtype) for p, k in zip(leaves,
                                                               keys)])


def _jax_draws(n_actions, param_noise):
    """A jitted replay of one JAX cycle's draws with its key schedule:
    a split a step (the coin and the random action), then the sampler's
    and, with param_noise, the two perturbations'. Env-free: the frames
    come from JAX's ring."""

    @jax.jit
    def draws(state):
        key, out = state.key, {}
        if param_noise:
            key, pkey = jax.random.split(key)
            out["act_noise"] = _jax_noise(state.params, pkey)

        def body(key, _):
            key, akey, rkey = jax.random.split(key, 3)
            return key, (jax.random.uniform(akey, (NENVS,)),
                         jax.random.randint(rkey, (NENVS,), 0, n_actions))

        key, (u, rand) = jax.lax.scan(body, key, None, length=TRAIN_FREQ)
        key, skey = jax.random.split(key)
        out.update(explore_u=u, rand_actions=rand,
                   gumbel=jax.random.gumbel(skey, (BATCH, CAP)))
        if param_noise:
            key, adkey = jax.random.split(key)
            out["adapt_noise"] = _jax_noise(state.params, adkey)
        return out

    return draws


def _ring_run(rb, steps: int):
    """The frames [steps + 1, N, ...], rewards and dones [steps, N] of a
    run that filled a JAX ring from its start, one row per env a step."""
    def rows(x):
        x = np.asarray(x)[:steps * NENVS]
        return x.reshape((steps, NENVS) + x.shape[1:])

    obs, nxt = rows(rb.obs), rows(rb.next_obs)
    return (np.concatenate([obs, nxt[-1:]]), rows(rb.rewards),
            rows(rb.dones))


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _run_cycles(n_cycles, param_noise, **kw):
    """JAX's cycles from init_fn(0) and the port's fed their draws and
    frames, compared after each."""
    jenv = j_make_rl_env("gridworld", NENVS)
    init_fn, cycle, qnet = jdqn.make_dqn(
        jenv, network="cnn_small", buffer_size=CAP, batch_size=BATCH,
        train_freq=TRAIN_FREQ, total_timesteps=1000, param_noise=param_noise,
        **kw)
    replay = _jax_draws(jenv.num_actions, param_noise)
    step = jax.jit(cycle)
    # jitted, init_fn compiles once instead of op by op
    states, draws, metrics = [jax.jit(init_fn, static_argnums=0)(0)], [], []
    for _ in range(n_cycles):
        draws.append(_np(replay(states[-1])))
        s, m = step(states[-1])
        states.append(s)
        metrics.append(_np(m))
    frames, rewards, dones = _ring_run(states[-1].replay,
                                       n_cycles * TRAIN_FREQ)
    assert np.array_equal(frames[0], np.asarray(states[0].env_state.frames))
    # no DQN metric reads the episode returns
    env = playback_env(frames, rewards, dones,
                       np.full(rewards.shape, np.nan, np.float32),
                       jenv.num_actions)
    tinit, tcycle, module = dqn.make_dqn(
        env, network="cnn_small", buffer_size=CAP, batch_size=BATCH,
        train_freq=TRAIN_FREQ, total_timesteps=1000, param_noise=param_noise,
        device="cpu", **kw)
    st = tinit(0)
    module.load_state_dict(params_from_flax(_np(states[0].params)))
    st.target.load_state_dict(module.state_dict())
    names = [n for n, _ in module.named_parameters()]
    for c, d in enumerate(draws):
        if param_noise:
            cd = {"act_noise": params_from_flax(d["act_noise"])}
            od = {"adapt_noise": params_from_flax(d["adapt_noise"])}
        else:
            cd = {k: _t(d[k]) for k in ("explore_u", "rand_actions")}
            od = {}
        od["gumbel"] = _t(d["gumbel"])
        t_before = tcycle.collect(st, cd)
        st, m = tcycle.optimize(st, t_before, od)
        want = states[c + 1]
        assert st.t == int(want.t)
        _assert_named(module.state_dict(), want.params, f"cycle {c} params")
        _assert_named(st.target.state_dict(), want.target_params,
                      f"cycle {c} target")
        adam = _adam_state(want.opt_state)
        assert st.adam.count == int(adam.count), c
        for what, got in (("mu", st.adam.mu), ("nu", st.adam.nu)):
            _assert_named(dict(zip(names, got)), getattr(adam, what),
                          f"cycle {c} {what}")
        jrb, rb = want.replay, st.replay
        assert (rb.cursor, rb.size) == (int(jrb.cursor), int(jrb.size))
        for k in ("obs", "next_obs", "actions", "rewards", "dones"):
            np.testing.assert_array_equal(getattr(rb, k).numpy(),
                                          np.asarray(getattr(jrb, k)),
                                          err_msg=f"cycle {c} {k}")
        _assert_close(rb.priorities, jrb.priorities, f"cycle {c} prio")
        assert set(m) == set(metrics[c])
        for k, v in metrics[c].items():
            _assert_close(m[k], v, f"cycle {c} {k}")
        _assert_close(st.pn_scale, want.pn_scale, f"cycle {c} pn_scale")
    return states, st


def test_cycles_match_jax_across_warmup_and_target_sync():
    states, st = _run_cycles(3, False, learning_starts=8,
                             target_network_update_freq=12)
    s0, s1, s2, s3 = states
    # cycle 1 (t 0 -> 4) is before learning_starts: nothing moves
    assert int(_adam_state(s1.opt_state).count) == 0
    assert float(jnp.max(s1.replay.priorities)) == 1.0
    # cycle 2 (t 4 -> 8): the first Adam step, new priorities
    assert int(_adam_state(s2.opt_state).count) == 1
    assert float(jnp.min(s2.replay.priorities[:8])) < 1.0
    moved = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(
        jax.tree_util.tree_leaves(s2.params),
        jax.tree_util.tree_leaves(s1.params)))
    assert moved > 1e-5
    # the target follows the params at t 12 only (12 // 12 != 8 // 12)
    assert all(bool(jnp.all(a == b)) for a, b in zip(
        jax.tree_util.tree_leaves(s2.target_params),
        jax.tree_util.tree_leaves(s0.params)))
    assert all(bool(jnp.all(a == b)) for a, b in zip(
        jax.tree_util.tree_leaves(s3.target_params),
        jax.tree_util.tree_leaves(s3.params)))
    assert st.update == 3


def test_param_noise_cycles_match_jax():
    states, st = _run_cycles(2, True, learning_starts=4,
                             target_network_update_freq=1000,
                             param_noise_scale0=0.05)
    assert float(states[2].pn_scale) != 0.05
    assert int(_adam_state(states[2].opt_state).count) == 2


# ---------------------------------------------------------------------------
# Learning, learn(), the CLI
# ---------------------------------------------------------------------------

class _Rows:
    def __init__(self):
        self.rows, self.row = [], {}

    def logkv(self, k, v):
        self.row[k] = v

    def dumpkvs(self):
        self.rows.append(self.row)
        self.row = {}


def test_learn_runs_blocks_saves_and_resumes(tmp_path):
    """jit_cycles 3, train_freq 2, 4 envs: 24 env frames (frameskip 1) a
    block, so total 80 runs 3 blocks; the saved file reads in JAX; a
    second learn to 5 blocks resumes from the checkpoint of block 3."""
    kw = dict(network="mlp", train_freq=2, batch_size=8, buffer_size=64,
              learning_starts=16, target_network_update_freq=16,
              jit_cycles=3, log_interval=1, device="cpu",
              checkpoint_path=str(tmp_path / "ck"), checkpoint_freq=1,
              network_kwargs=dict(num_hidden=8))
    log = _Rows()
    path = str(tmp_path / "q.model")
    s3 = dqn.learn(env=make_discrete_identity_env(4, dim=3, device="cpu"),
                   total_timesteps=80, logger=log, save_path=path, **kw)
    assert s3.update == 9 and s3.t == 9 * 2 * 4
    assert [r["steps"] for r in log.rows] == [24, 48, 72]
    assert set(log.rows[0]) == {"steps", "fps", *dqn.METRICS}
    assert s3.adam.count == 8           # cycles 2..9: t >= 16 after each
    trunk = get_network_builder("mlp")(num_hidden=8)
    jmod = jdqn.QNetwork(trunk=trunk, n_actions=3)
    template = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    back = params_from_flax(_np(jppo.load_params(path, template)))
    for k, v in s3.module.state_dict().items():
        assert torch.equal(back[k], v), k
    replay3 = s3.replay.obs.clone()
    s5 = dqn.learn(env=make_discrete_identity_env(4, dim=3, device="cpu"),
                   total_timesteps=5 * 24, **kw)
    assert s5.update == 15 and s5.t == 15 * 8 and s5.adam.count == 14
    assert s5.replay.size == 64 and not torch.equal(s5.replay.obs, replay3)


def test_run_main_trains_saves_and_plays_deepq(tmp_path, monkeypatch,
                                               capsys):
    """``--alg=deepq`` (conv_only, dueling) trains on Breakout, saves a
    file that JAX's load_params reads, and plays eps-greedy."""
    monkeypatch.setattr(run, "PLAY_ENVS", 2)
    monkeypatch.setattr(run, "PLAY_CHUNKS", 1)
    monkeypatch.setattr(run, "PLAY_CHUNK", 3)
    path = str(tmp_path / "dqn.model")
    state = run.main(["--alg=dqn", "--env=BreakoutToyboxNoFrameskip-v4",
                      "--num_envs=2", "--train_freq=2", "--batch_size=4",
                      "--buffer_size=32", "--learning_starts=4",
                      "--jit_cycles=2", "--num_timesteps=64",
                      "--device=cpu", f"--save_path={path}",
                      f"--log_path={tmp_path / 'log'}", "--play"])
    assert state.update == 4 and state.adam.count == 4
    capsys.readouterr()
    template = jdqn.QNetwork(trunk=get_network_builder("conv_only")(),
                             n_actions=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 84, 84, 4), jnp.uint8))
    back = params_from_flax(_np(jppo.load_params(path, template)))
    from toybox_tpu_torch.rl.eval_adapter import load_eval_params
    head = load_eval_params("deepq", "conv_only", path, "breakout",
                            device="cpu")
    for k, v in state.module.state_dict().items():
        assert torch.equal(back[k], v), k
        assert torch.equal(head.state_dict()[k], v), k
    args = run.common_arg_parser().parse_args(["--device=cpu",
                                               "--alg=deepq"])
    returns = run.play(args, state)
    assert capsys.readouterr().out.count("episode_rew=") == len(returns)

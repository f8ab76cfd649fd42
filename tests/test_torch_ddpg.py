"""The port's DDPG (toybox_tpu_torch.rl.ddpg) and box identity env
against the JAX package's.

- The box identity env's contract (targets uniform in [-1, 1), reward
  -||a - target||^2, episodes of 50 steps, no legal-action list) and its
  steps fed the JAX env's targets: the same rewards and dones.
- Three cycles of ``make_ddpg`` (4 envs, dim 2, a ring of 64, batches of
  16) against JAX's ``cycle`` from ``init_fn(0)``, the JAX params carried
  across, across ``learning_starts`` 8: the first two cycles move the
  critic but not the actor, whose Adam moments and count advance all the
  same; the third moves both. JAX's draws are replayed with its key
  schedule (the action noise and the sample indices of a cycle from one
  three-way split) and its env's targets fed to the port's env.
  Compared after each cycle: actor, critic, both targets, both Adam
  states, the ring and the metrics. Tolerance: params and moments within
  1e-6 absolute, as PPO's; the metrics within 1e-5 relative or 1e-6
  absolute.
- The learning test tests/test_rl_learning.py:116-130 at JAX's threshold
  (mean reward > -0.35 after 600 cycles), and ``learn``'s logging.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_dqn import _Rows, _assert_close, _np, _t
from tests.test_torch_ppo1 import _adam
from toybox_tpu.rl import ddpg as jddpg
from toybox_tpu.rl.test_envs import make_box_identity_env as j_box
from toybox_tpu_torch.rl import ddpg
from toybox_tpu_torch.rl.checkpoint import dense_stack_from_flax
from toybox_tpu_torch.rl.test_envs import make_box_identity_env

NENVS, DIM, CAP, BATCH = 4, 2, 64, 16


def test_box_identity_env_contract_and_jax_targets():
    env = make_box_identity_env(3, dim=2, device="cpu")
    assert env.legal_actions == () and env.obs_shape == (2,)
    assert env.num_actions == 2
    st, obs = env.reset(torch.arange(3))
    st2, obs2 = env.reset(torch.tensor([2, 1, 0]))     # the sum seeds it
    assert torch.equal(obs, obs2) and obs.shape == (3, 2)
    for t in range(1, 51):
        a = torch.zeros(3, 2)
        target = st.frames
        st, obs, rew, done, info = env.step(st, a)
        assert torch.allclose(rew, -(target ** 2).sum(-1))
        assert bool((obs >= -1).all() and (obs < 1).all())
        assert bool(done.all()) == (t == 50)
        assert bool(torch.isnan(info["episode_return"]).all()) != (t == 50)
    assert int(st.t.max()) == 0                # t reset on done
    # fed the JAX env's targets, the same rewards
    jenv = j_box(3, dim=2, episode_len=4)
    jst, jobs = jenv.reset(jnp.arange(3, dtype=jnp.uint32))
    r = np.random.default_rng(0)
    acts = r.uniform(-1, 1, (5, 3, 2)).astype(np.float32)
    targets, rewards, dones = [np.asarray(jobs)], [], []
    for a in acts:
        jst, jobs, jr, jd, _ = jenv.step(jst, jnp.asarray(a))
        targets.append(np.asarray(jobs))
        rewards.append(np.asarray(jr))
        dones.append(np.asarray(jd))
    env = make_box_identity_env(3, dim=2, episode_len=4, device="cpu",
                                targets=_t(np.stack(targets)))
    st, obs = env.reset(torch.arange(3))
    np.testing.assert_array_equal(obs.numpy(), targets[0])
    for i, a in enumerate(acts):
        st, obs, rew, done, _ = env.step(st, _t(a))
        np.testing.assert_array_equal(obs.numpy(), targets[i + 1])
        np.testing.assert_allclose(rew.numpy(), rewards[i], rtol=1e-6)
        np.testing.assert_array_equal(done.numpy(), dones[i])


def _assert_dense(got: dict, want_tree, what, atol=1e-6):
    want = dense_stack_from_flax(_np(want_tree))
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=atol, err_msg=f"{what} {k}")


def test_cycles_match_jax_across_learning_starts():
    n_cycles = 3
    kw = dict(actor_lr=3e-3, critic_lr=3e-3, buffer_size=CAP,
              batch_size=BATCH, noise_scale=0.2, learning_starts=8)
    jenv = j_box(NENVS, dim=DIM)
    init_fn, cycle, _ = jddpg.make_ddpg(jenv, DIM, **kw)
    states = [jax.jit(init_fn, static_argnums=0)(0)]
    step = jax.jit(cycle)
    draws, metrics = [], []
    for c in range(n_cycles):
        _, nkey, skey = jax.random.split(states[-1].key, 3)
        size = min((c + 1) * NENVS, CAP)
        draws.append({"noise": _t(jax.random.normal(nkey, (NENVS, DIM))),
                      "idx": _t(jax.random.randint(skey, (BATCH,), 0,
                                                   size)).long()})
        s, m = step(states[-1])
        states.append(s)
        metrics.append(_np(m))
    targets = np.stack([np.asarray(s.env_state.frames) for s in states])
    env = make_box_identity_env(NENVS, dim=DIM, device="cpu",
                                targets=_t(targets))
    tinit, tcycle, _ = ddpg.make_ddpg(env, DIM, device="cpu", **kw)
    st = tinit(0)
    s0 = states[0]
    for module, tree in ((st.actor, s0.actor), (st.critic, s0.critic),
                         (st.target_actor, s0.actor),
                         (st.target_critic, s0.critic)):
        module.load_state_dict(dense_stack_from_flax(_np(tree)))
    names = {"actor": [n for n, _ in st.actor.named_parameters()],
             "critic": [n for n, _ in st.critic.named_parameters()]}
    for c, d in enumerate(draws):
        st, m = tcycle(st, d)
        want = states[c + 1]
        assert st.t == int(want.t) == (c + 1) * NENVS
        for what in ("actor", "critic", "target_actor", "target_critic"):
            _assert_dense(getattr(st, what).state_dict(),
                          getattr(want, what), f"cycle {c} {what}")
        for what in ("actor", "critic"):
            adam, jadam = getattr(st, f"{what}_adam"), _adam(
                getattr(want, f"{what}_opt"))
            assert adam.count == int(jadam.count) == c + 1, (c, what)
            for k in ("mu", "nu"):
                _assert_dense(dict(zip(names[what], getattr(adam, k))),
                              getattr(jadam, k), f"cycle {c} {what} {k}")
        jrb, rb = want.replay, st.replay
        assert (rb.cursor, rb.size) == (int(jrb.cursor), int(jrb.size))
        for k in ("obs", "next_obs", "actions", "rewards", "dones"):
            np.testing.assert_allclose(getattr(rb, k).numpy(),
                                       np.asarray(getattr(jrb, k)), rtol=0,
                                       atol=1e-6, err_msg=f"cycle {c} {k}")
        assert set(m) == set(metrics[c])
        for k, v in metrics[c].items():
            _assert_close(m[k], v, f"cycle {c} {k}")
    # before learning_starts the actor stayed, after it it moved
    a = [jax.tree_util.tree_leaves(s.actor) for s in states]
    assert all(bool(jnp.all(x == y)) for x, y in zip(a[0], a[2]))
    assert any(not bool(jnp.all(x == y)) for x, y in zip(a[2], a[3]))
    assert not all(bool(jnp.all(x == y)) for x, y in zip(
        jax.tree_util.tree_leaves(states[0].critic),
        jax.tree_util.tree_leaves(states[1].critic)))


def test_ddpg_learns_box_identity():
    """tests/test_rl_learning.py:116-130 in the port."""
    env = make_box_identity_env(8, dim=2, device="cpu")
    init_fn, cycle, _ = ddpg.make_ddpg(env, action_dim=2, actor_lr=3e-3,
                                       critic_lr=3e-3, batch_size=128,
                                       buffer_size=8192, noise_scale=0.2,
                                       learning_starts=256, device="cpu")
    state = init_fn(0)
    for _ in range(600):
        state, last = cycle(state)
    r = float(last["mean_reward"])
    assert r > -0.35, f"ddpg failed to learn box identity: {r}"


def test_learn_logs_every_interval():
    log = _Rows()
    state = ddpg.learn(env=make_box_identity_env(4, dim=2, device="cpu"),
                       action_dim=2, total_timesteps=4 * 6, batch_size=8,
                       buffer_size=32, log_interval=3, logger=log,
                       device="cpu")
    assert state.update == 6 and state.t == 24
    assert [r["steps"] for r in log.rows] == [12, 24]
    assert set(log.rows[0]) == {"steps", "fps", "critic_loss",
                                "actor_loss", "mean_reward"}
    with pytest.raises(TypeError, match="unexpected"):
        ddpg.learn(env=make_box_identity_env(4, dim=2, device="cpu"),
                   action_dim=2, cycles_per_jit=2, device="cpu")

"""The port's image-class env (toybox_tpu_torch.rl.test_envs
``make_image_class_env``) against the JAX package's, and PPO learning it.

- The env fed JAX's class templates and its per-step draws (the classes
  and the pixel flips, replayed with JAX's key schedule): the same
  frames, rewards, dones and info, exactly.
- tests/test_rl_learning.py:441 in the port: PPO with cnn_small on 16
  envs of 4 classes, 200 updates, mean reward > 0.6 (chance 0.25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.rl.test_envs import make_image_class_env as j_image
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.test_envs import make_image_class_env

N, C, SIZE, EP_LEN, NOISE = 3, 4, 12, 3, 0.05


def _draws(key):
    """(class, flips) of one image draw from ``key``, JAX's schedule."""
    key, ckey, nkey = jax.random.split(key, 3)
    target = jax.random.randint(ckey, (N,), 0, C)
    flip = jax.random.uniform(nkey, (N, SIZE, SIZE, 1)) < NOISE
    return np.asarray(target), np.asarray(flip)


def test_image_class_env_matches_jax():
    jenv = j_image(N, n_classes=C, size=SIZE, episode_len=EP_LEN,
                   noise=NOISE, seed=3)
    templates = np.array((jax.random.uniform(
        jax.random.PRNGKey(3), (C, SIZE, SIZE, 1)) < 0.5).astype(
            jnp.uint8) * 255)
    seeds = jnp.arange(N, dtype=jnp.uint32)
    jst, jobs0 = jenv.reset(seeds)
    targets, flips = [], []
    t, f = _draws(jax.random.fold_in(jax.random.PRNGKey(0),
                                     int(seeds.sum())))
    targets.append(t)
    flips.append(f)
    acts = np.random.default_rng(0).integers(0, C, (7, N))
    want = []
    for a in acts:
        t, f = _draws(jst.key)
        targets.append(t)
        flips.append(f)
        jst, jobs, jr, jd, jinfo = jenv.step(jst, jnp.asarray(a))
        want.append((np.asarray(jobs), np.asarray(jr), np.asarray(jd),
                     {k: np.asarray(v) for k, v in jinfo.items()}))
    env = make_image_class_env(N, n_classes=C, size=SIZE,
                               episode_len=EP_LEN, noise=NOISE,
                               device="cpu", templates=torch.as_tensor(
                                   templates),
                               targets=torch.as_tensor(np.stack(targets)),
                               flips=torch.as_tensor(np.stack(flips)))
    assert env.obs_shape == (SIZE, SIZE, 1) and env.num_actions == C
    st, obs = env.reset(torch.arange(N))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs0))
    for a, (wobs, wr, wd, winfo) in zip(acts, want):
        st, obs, rew, done, info = env.step(st, torch.as_tensor(a))
        np.testing.assert_array_equal(obs.numpy(), wobs)
        np.testing.assert_array_equal(rew.numpy(), wr)
        np.testing.assert_array_equal(done.numpy(), wd)
        assert set(info) == set(winfo)
        for k, v in winfo.items():
            np.testing.assert_array_equal(info[k].numpy(), v, err_msg=k)


def test_image_class_env_draws_its_own():
    env = make_image_class_env(4, n_classes=3, size=8, episode_len=2,
                               noise=0.0, device="cpu")
    st, obs = env.reset(torch.arange(4))
    assert obs.dtype == torch.uint8 and obs.shape == (4, 8, 8, 1)
    assert set(obs.unique().tolist()) <= {0, 255}
    st2, obs2 = env.reset(torch.tensor([3, 2, 1, 0]))   # the sum seeds it
    assert torch.equal(obs, obs2)
    st, _, rew, done, info = env.step(st, st.target)
    assert rew.tolist() == [1.0] * 4 and not bool(done.any())
    st, _, rew, done, info = env.step(st, (st.target + 1) % 3)
    assert rew.tolist() == [0.0] * 4 and bool(done.all())
    assert info["episode_return"].tolist() == [1.0] * 4


def test_ppo_learns_image_classification():
    """tests/test_rl_learning.py:441 in the port."""
    env = make_image_class_env(16, n_classes=4, size=28, episode_len=4,
                               device="cpu")
    init_fn, step, _ = ppo.make_ppo(
        env, network="cnn_small", nsteps=8, nminibatches=2, noptepochs=2,
        lr=1e-3, cliprange=0.2, gamma=0.1, total_updates=200, device="cpu")
    state = init_fn(0)
    for _ in range(200):
        state, last = step(state)
    r = float(last["mean_reward"])
    assert r > 0.6, f"ppo failed to classify images: {r} (chance 0.25)"

"""The port's action distributions (toybox_tpu_torch.rl.distributions)
against the JAX package's.

- tests/test_rl.py:28 (``test_diag_gaussian_pd``) in the port.
- MultiCategoricalPd, DiagGaussianPd and BernoulliPd on the same
  parameters (numpy seed 0) as JAX's: neglogp, entropy, kl and mode within
  1e-6, and ``sample`` fed the noise of JAX's draw equal to JAX's draw.
  Where JAX's class has no kl (MultiCategorical, Bernoulli), the port's is
  held against the reference's formula written with JAX's pieces.
- make_pdtype on every space kind: the same n_params; an unknown space
  raises NotImplementedError in both.
- build_policy on a Box space: the step draws through DiagGaussianPd.
"""

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.rl import distributions as jd
from toybox_tpu_torch.rl import distributions as pd
from toybox_tpu_torch.rl.policies import build_policy

ATOL = 1e-6
NCATS = (3, 5, 2)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg=what)


def _params(*shape, seed=0):
    return np.random.default_rng(seed).normal(0, 2, shape).astype(
        np.float32)


def test_diag_gaussian_pd():
    """tests/test_rl.py:28 in the port."""
    d = pd.DiagGaussianPd(torch.zeros(3, 2), torch.zeros(3, 2))
    x = d.sample(torch.Generator().manual_seed(1))
    assert x.shape == (3, 2)
    np.testing.assert_allclose(d.neglogp(torch.zeros(3, 2)).numpy(),
                               np.log(2 * np.pi), rtol=1e-5)


def test_multi_categorical_matches_jax():
    a, b = _params(4, sum(NCATS)), _params(4, sum(NCATS), seed=1)
    mine, theirs = pd.MultiCategoricalPd(torch.as_tensor(a), NCATS), \
        jd.MultiCategoricalPd(jnp.asarray(a), NCATS)
    other = pd.MultiCategoricalPd(torch.as_tensor(b), NCATS)
    acts = np.stack([np.random.default_rng(2).integers(0, n, 4)
                     for n in NCATS], -1)
    _close(mine.neglogp(torch.as_tensor(acts)),
           theirs.neglogp(jnp.asarray(acts)), "neglogp")
    _close(mine.entropy(), theirs.entropy(), "entropy")
    np.testing.assert_array_equal(mine.mode().numpy(),
                                  np.asarray(theirs.mode()))
    want_kl = sum(jd.CategoricalPd(x).kl(jd.CategoricalPd(y)) for x, y in zip(
        jnp.split(jnp.asarray(a), np.cumsum(NCATS)[:-1], -1),
        jnp.split(jnp.asarray(b), np.cumsum(NCATS)[:-1], -1)))
    _close(mine.kl(other), want_kl, "kl")
    # JAX's draw is one categorical per split key: argmax(logits + g)
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, len(NCATS))
    noise = np.concatenate([np.array(jax.random.gumbel(k, (4, n)))
                            for k, n in zip(keys, NCATS)], -1)
    np.testing.assert_array_equal(
        mine.sample(noise=torch.as_tensor(noise)).numpy(),
        np.asarray(theirs.sample(key)))
    assert mine.sample(torch.Generator().manual_seed(0)).shape == (4, 3)


def test_diag_gaussian_matches_jax():
    m, s = _params(5, 3), _params(5, 3, seed=1) * 0.3
    m2, s2 = _params(5, 3, seed=2), _params(5, 3, seed=3) * 0.3
    x = _params(5, 3, seed=4)
    mine = pd.DiagGaussianPd(torch.as_tensor(m), torch.as_tensor(s))
    theirs = jd.DiagGaussianPd(jnp.asarray(m), jnp.asarray(s))
    _close(mine.neglogp(torch.as_tensor(x)), theirs.neglogp(jnp.asarray(x)),
           "neglogp")
    _close(mine.entropy(), theirs.entropy(), "entropy")
    _close(mine.kl(pd.DiagGaussianPd(torch.as_tensor(m2),
                                     torch.as_tensor(s2))),
           theirs.kl(jd.DiagGaussianPd(jnp.asarray(m2), jnp.asarray(s2))),
           "kl")
    _close(mine.mode(), theirs.mode(), "mode")
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, m.shape, jnp.float32))
    _close(mine.sample(noise=torch.as_tensor(noise)), theirs.sample(key),
           "sample")


def test_bernoulli_matches_jax():
    a, b = _params(4, 6), _params(4, 6, seed=1)
    x = np.random.default_rng(2).integers(0, 2, (4, 6))
    mine, theirs = pd.BernoulliPd(torch.as_tensor(a)), \
        jd.BernoulliPd(jnp.asarray(a))
    _close(mine.neglogp(torch.as_tensor(x)), theirs.neglogp(jnp.asarray(x)),
           "neglogp")
    _close(mine.entropy(), theirs.entropy(), "entropy")
    np.testing.assert_array_equal(mine.mode().numpy(),
                                  np.asarray(theirs.mode()))
    # the reference's kl: cross-entropy of p under other minus under self
    p = jax.nn.sigmoid(jnp.asarray(a))
    _close(mine.kl(pd.BernoulliPd(torch.as_tensor(b))),
           jd.BernoulliPd(jnp.asarray(b)).neglogp(p) - theirs.neglogp(p),
           "kl")
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, a.shape))
    np.testing.assert_array_equal(
        mine.sample(noise=torch.as_tensor(u)).numpy(),
        np.asarray(theirs.sample(key)))


def test_categorical_sample_with_noise_or_generator():
    logits = torch.as_tensor(_params(6, 4))
    g = torch.as_tensor(-np.log(-np.log(np.random.default_rng(3).uniform(
        size=(6, 4))))).float()
    d = pd.CategoricalPd(logits)
    assert torch.equal(d.sample(noise=g), pd.gumbel_max(logits, g))
    gen = torch.Generator().manual_seed(0)
    a = d.sample(gen)
    gen.manual_seed(0)
    assert torch.equal(a, pd.gumbel_max(logits, pd.gumbel(
        (6, 4), gen, "cpu")))


@pytest.mark.parametrize("space", [
    7, gymnasium.spaces.Discrete(5),
    gymnasium.spaces.MultiDiscrete([3, 4]),
    gymnasium.spaces.Box(-1, 1, (2, 3)),
    gymnasium.spaces.MultiBinary(6)])
def test_make_pdtype_matches_jax(space):
    n, build = pd.make_pdtype(space)
    assert n == jd.make_pdtype(space)[0]
    d = build(torch.zeros(2, n))
    kind = {int: "CategoricalPd"}.get(type(space), {
        "Discrete": "CategoricalPd", "MultiDiscrete": "MultiCategoricalPd",
        "Box": "DiagGaussianPd", "MultiBinary": "BernoulliPd"}.get(
            type(space).__name__))
    assert type(d).__name__ == kind == type(
        jd.make_pdtype(space)[1](jnp.zeros((2, n)))).__name__
    assert pd.pd_from_logits(space, torch.zeros(2, n)).entropy().shape == (2,)


def test_make_pdtype_refuses_unknown_space():
    with pytest.raises(NotImplementedError):
        jd.make_pdtype(gymnasium.spaces.Text(3))
    with pytest.raises(NotImplementedError):
        pd.make_pdtype(gymnasium.spaces.Text(3))


def test_build_policy_on_box_space():
    space = gymnasium.spaces.Box(-1, 1, (2,))
    module, init_fn, step_fn, value_fn = build_policy(
        (4,), space, "mlp", device="cpu", num_hidden=8)
    init_fn(0)
    obs = torch.as_tensor(_params(5, 4))
    gen = torch.Generator().manual_seed(0)
    actions, values, neglogps, flat = step_fn(obs, gen)
    assert flat.shape == (5, 4) and actions.shape == (5, 2)
    assert values.shape == neglogps.shape == (5,)
    mean, logstd = flat.chunk(2, -1)
    gen.manual_seed(0)
    want = pd.DiagGaussianPd(mean, logstd).sample(gen)
    assert torch.equal(actions, want)
    np.testing.assert_allclose(
        neglogps.numpy(),
        pd.DiagGaussianPd(mean, logstd).neglogp(actions).numpy())

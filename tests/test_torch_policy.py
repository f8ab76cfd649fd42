"""The port's checkpoint reader, NatureCNN policy and categorical
distribution against flax / the JAX package."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from toybox_tpu.rl.distributions import CategoricalPd as JPd
from toybox_tpu.rl.policies import build_eval_policy as j_build_eval_policy
from toybox_tpu.rl.policies import build_policy as j_build_policy
from toybox_tpu.rl.ppo import load_params
from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.rl import checkpoint
from toybox_tpu_torch.rl.distributions import CategoricalPd as TPd
from toybox_tpu_torch.rl.policies import build_eval_policy

MODEL = "models/Breakout.regress.model"
OBS_SHAPE = (84, 84, 4)


@pytest.fixture(scope="module")
def jax_params():
    init_fn, _ = j_build_eval_policy("ppo", OBS_SHAPE, 4, "cnn")
    return load_params(MODEL, init_fn(jax.random.PRNGKey(0)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_reader_matches_flax_leaf_for_leaf(jax_params):
    ours = _leaves(checkpoint.load_flax_tree(MODEL))
    with open(MODEL, "rb") as f:
        theirs = _leaves(serialization.msgpack_restore(f.read()))
    loaded = _leaves(serialization.to_state_dict(jax_params))
    assert set(ours) == set(theirs) == set(loaded)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        np.testing.assert_array_equal(ours[k], loaded[k], err_msg=k)


def test_reader_decodes_msgpack_types():
    arr = np.arange(6, dtype=np.int16).reshape(2, 3)
    obj = {"a": [1, -1, 127, 128, -33, 70000, -70000, 2 ** 40, -2 ** 40,
                 2 ** 64 - 1],
           "b": [1.5, float("inf"), True, False, None, "x" * 40,
                 "y" * 300, b"\x00\x01", b"z" * 70000, list(range(20))],
           "c": {str(i): i for i in range(20)},
           "arr": arr, "scalar": np.float32(2.5), "z": complex(1, -2)}
    data = serialization.msgpack_serialize(obj)
    back = checkpoint.unpackb(data)
    ref = serialization.msgpack_restore(data)
    assert back["a"] == ref["a"] and back["c"] == ref["c"]
    assert back["b"] == ref["b"] and back["z"] == ref["z"]
    np.testing.assert_array_equal(back["arr"], arr)
    assert back["arr"].dtype == arr.dtype
    assert back["scalar"] == np.float32(2.5)
    assert checkpoint.unpackb(msgpack.packb(3.25, use_single_float=True)) \
        == 3.25
    with pytest.raises(ValueError):
        checkpoint.unpackb(data + b"\x00")


def _pipeline_obs(n=6, steps=12):
    env = make_rl_env("breakout", n, device="cpu")
    st, obs = env.reset(torch.arange(n))
    r = np.random.default_rng(0)
    for _ in range(steps):
        st, obs, _, _, _ = env.step(st, torch.as_tensor(r.integers(0, 4, n)))
    return obs.numpy()


def test_logits_and_value_match_jax(jax_params):
    module, _ = build_eval_policy("ppo", OBS_SHAPE, 4, "cnn", device="cpu")
    module.load_state_dict(checkpoint.load_state_dict(MODEL))
    jmodule, _, _, _ = j_build_policy(OBS_SHAPE, 4, "cnn")
    r = np.random.default_rng(1)
    obs = np.concatenate([_pipeline_obs(),
                          r.integers(0, 256, (2,) + OBS_SHAPE, np.uint8)])
    jl, jv = jmodule.apply(jax_params, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = module(torch.as_tensor(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)


def test_categorical_matches_jax():
    r = np.random.default_rng(2)
    logits = (r.standard_normal((64, 4)) * 3).astype(np.float32)
    acts = r.integers(0, 4, 64)
    j, t = JPd(jnp.asarray(logits)), TPd(torch.as_tensor(logits))
    np.testing.assert_array_equal(t.mode().numpy(), np.asarray(j.mode()))
    np.testing.assert_allclose(t.neglogp(torch.as_tensor(acts)).numpy(),
                               np.asarray(j.neglogp(jnp.asarray(acts))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.entropy().numpy(), np.asarray(j.entropy()),
                               atol=1e-5, rtol=0)


def test_categorical_sample_follows_probabilities():
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]])).expand(20000, 4)
    g = torch.Generator().manual_seed(0)
    a = TPd(logits).sample(g)
    freq = torch.bincount(a, minlength=4).double() / a.numel()
    assert torch.allclose(freq, torch.tensor([0.1, 0.2, 0.3, 0.4],
                                             dtype=torch.float64), atol=0.015)
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(TPd(logits).sample(g2), a)


@pytest.mark.parametrize("model,game,n_actions", [
    ("models/SpaceInvaders.regress.model", "space_invaders", 6),
    ("models/Amidar.regress.model", "amidar", 10)])
def test_other_regress_checkpoints_match_jax(model, game, n_actions):
    """The Space Invaders and Amidar gate models: the reader leaf for leaf
    against flax, then logits and values on the game's own pipeline
    observations within 1e-4 of the JAX policy."""
    init_fn, _ = j_build_eval_policy("ppo", OBS_SHAPE, n_actions, "cnn")
    params = load_params(model, init_fn(jax.random.PRNGKey(0)))
    ours = _leaves(checkpoint.load_flax_tree(model))
    loaded = _leaves(serialization.to_state_dict(params))
    assert set(ours) == set(loaded)
    for k in ours:
        np.testing.assert_array_equal(ours[k], loaded[k], err_msg=k)
    assert ours["/params/Dense_0/kernel"].shape == (512, n_actions)

    env = make_rl_env(game, 4, device="cpu")
    assert env.num_actions == n_actions
    st, obs = env.reset(torch.arange(4))
    r = np.random.default_rng(3)
    for _ in range(30):
        st, obs, _, _, _ = env.step(
            st, torch.as_tensor(r.integers(0, n_actions, 4)))
    obs = obs.numpy()
    module, _ = build_eval_policy("ppo", OBS_SHAPE, n_actions, "cnn",
                                  device="cpu")
    module.load_state_dict(checkpoint.load_state_dict(model))
    jmodule, _, _, _ = j_build_policy(OBS_SHAPE, n_actions, "cnn")
    jl, jv = jmodule.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = module(torch.as_tensor(obs))
    assert tl.shape == (4, n_actions)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)

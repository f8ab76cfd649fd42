"""deepq's QNetwork, dueling or not, against flax's, and the checkpoint
templates that tell its non-dueling tree from PolicyWithValue's by the
Dense shapes (the two share the keys trunk, Dense_0 and Dense_1):

- the port's QNetwork (cnn_small, conv_only, mlp; dueling and not) fed
  flax's params: Q within 1e-5, and both templates named;
- a non-dueling deepq tree, a dueling one and an acer tree over the same
  trunk, each written by JAX's save_params: each its own template, and
  params_to_flax the exact inverse of params_from_flax;
- the 37 committed files keep their templates
  (tests/test_torch_checkpoints.py's TEMPLATES); a pair of Dense layers
  that fits both templates raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.rl import dqn as jdqn
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl.models import get_network_builder
from toybox_tpu.rl.policies import PolicyWithValue as JPolicyWithValue
from toybox_tpu_torch.rl import checkpoint, dqn
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.models import network_factory


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)



def _jax_q(network, dueling, obs, nact=6, **kw):
    trunk = get_network_builder(network)(**kw)
    module = jdqn.QNetwork(trunk=trunk, n_actions=nact, dueling=dueling)
    return module, module.init(jax.random.PRNGKey(3), jnp.asarray(obs[:1]))


@pytest.mark.parametrize("network,dueling", [("cnn_small", False),
                                             ("conv_only", False),
                                             ("mlp", False),
                                             ("cnn_small", True)])
def test_qnetwork_matches_flax(network, dueling):
    r = np.random.default_rng(1)
    shape = (84, 84, 4) if network != "mlp" else (5,)
    obs = (r.integers(0, 256, (3,) + shape).astype(np.uint8)
           if network != "mlp" else r.normal(size=(3,) + shape)
           .astype(np.float32))
    jmod, params = _jax_q(network, dueling, obs)
    want = np.asarray(jmod.apply(params, jnp.asarray(obs)))
    module = dqn.QNetwork(network_factory(network)(shape), 6,
                          dueling=dueling)
    sd = params_from_flax(_np(params))
    module.load_state_dict(sd, strict=True)
    got = module(torch.as_tensor(obs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    head = "dueling_q" if dueling else "q"
    assert checkpoint.flax_template(_np(params)) == f"{head}:{network}"
    assert checkpoint.state_dict_template(module.state_dict()) == \
        f"{head}:{network}"


@pytest.mark.parametrize("network", ["conv_only", "cnn_small", "mlp"])
def test_q_dueling_and_acer_trees_of_one_trunk_get_their_templates(
        network, tmp_path):
    """A non-dueling deepq file, a dueling one and an acer file over the
    same trunk, each written by JAX's save_params: the template by shape,
    and params_to_flax the exact inverse of params_from_flax."""
    shape = (84, 84, 4) if network != "mlp" else (4,)
    obs = np.zeros((1,) + shape, np.uint8 if network != "mlp"
                   else np.float32)
    acer = JPolicyWithValue(trunk=get_network_builder(network)(),
                            n_pdparams=4, estimate_q=True)
    trees = {"q": _jax_q(network, False, obs, nact=4)[1],
             "dueling_q": _jax_q(network, True, obs, nact=4)[1],
             "pi_v": acer.init(jax.random.PRNGKey(0), jnp.asarray(obs))}
    for head, tree in trees.items():
        path = tmp_path / f"{head}.model"
        jppo.save_params(str(path), tree)
        loaded = checkpoint.load_flax_tree(path)
        assert checkpoint.flax_template(loaded) == f"{head}:{network}"
        sd = params_from_flax(loaded)
        back = checkpoint.params_to_flax(sd)
        assert checkpoint.packb(back) == checkpoint.packb(
            {"params": loaded["params"]})


def test_committed_files_keep_their_templates():
    """The 37 committed files: none takes the new q template."""
    from tests.test_torch_checkpoints import MODELS, TEMPLATES, _tree
    assert len(MODELS) == 37
    for name in MODELS:
        assert checkpoint.flax_template(_tree(name)) == \
            TEMPLATES[name.split(".")[1]], name


def test_template_raises_on_an_ambiguous_pair():
    tree = {"params": {"trunk": {"Dense_0": {"kernel": np.zeros((3, 8)),
                                             "bias": np.zeros(8)}},
                       "Dense_0": {"kernel": np.zeros((8, 8)),
                                   "bias": np.zeros(8)},
                       "Dense_1": {"kernel": np.zeros((8, 8)),
                                   "bias": np.zeros(8)}}}
    with pytest.raises(ValueError, match="both"):
        checkpoint.flax_template(tree)

"""Every committed checkpoint against the port's eval heads, with no JAX:
each of the 37 files loads strictly into the head its name (or its
family) names; ``params_to_flax`` gives back the file's ``params``
exactly, byte for byte once packed; the 9 x 3 family grid loads as
tests/test_families.py loads it in the JAX package; and trees the port
does not know raise."""

import functools
import pathlib

import numpy as np
import pytest
import torch

from toybox_tpu_torch.rl import checkpoint
from toybox_tpu_torch.rl.eval_adapter import (CHECKPOINT_HEADS,
                                              checkpoint_head, eval_head,
                                              load_eval_params)
from toybox_tpu_torch.sample_tests.families import (FAMILIES, GAME_PREFIX,
                                                    model_path)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these ops are small, and the test workers
    share the cores (as tests/test_torch_codecs.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = sorted(p.name for p in (ROOT / "models").glob("*.model"))
GAME_OF = {v: k for k, v in GAME_PREFIX.items()}
#: the template of each checkpoint suffix (the six of the committed files)
TEMPLATES = {
    "regress": "pi_v:cnn", "ppo_bf16": "pi_v:cnn", "ppo1": "pi_v:cnn",
    "a2c": "pi_v:cnn", "a2c_bf16": "pi_v:cnn", "gail": "pi_v:cnn",
    "bc": "pi_v:cnn", "trpo": "pi_v:cnn_small", "acer": "pi_v:cnn_small",
    "deepq": "dueling_q:conv_only", "acktr": "kfac:cnn",
    "ppo_lstm": "pi_v:cnn_lstm", "a2c_lstm": "pi_v:cnn_lstm",
    "acer_lstm": "pi_v:cnn_lstm", "ppo_lnlstm": "pi_v:cnn_lnlstm",
}


@functools.lru_cache(maxsize=None)
def _tree(name):
    return checkpoint.load_flax_tree(ROOT / "models" / name)


def _game(name):
    return GAME_OF[name.split(".")[0]]


def test_all_37_checkpoints_are_listed():
    assert len(MODELS) == 37
    assert {m.split(".")[1] for m in MODELS} == set(CHECKPOINT_HEADS) \
        == set(TEMPLATES)


@pytest.mark.parametrize("name", MODELS)
def test_checkpoint_loads_strictly_into_its_head(name):
    alg, network = checkpoint_head(name)
    assert checkpoint.flax_template(_tree(name)) == \
        TEMPLATES[name.split(".")[1]]
    module, _ = eval_head(alg, network, _game(name), device="cpu")
    sd = checkpoint.params_from_flax(_tree(name))
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd, strict=True)
    for k, v in module.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k


def _equal_trees(a, b, where=()):
    assert isinstance(a, dict) == isinstance(b, dict), where
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal_trees(a[k], b[k], where + (k,))
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where


@pytest.mark.parametrize("name", MODELS)
def test_params_to_flax_inverts_params_from_flax(name):
    tree = _tree(name)
    template = checkpoint.flax_template(tree)
    back = checkpoint.params_to_flax(checkpoint.params_from_flax(tree),
                                     template)
    _equal_trees(back, {"params": tree["params"]})
    assert checkpoint.packb(back) == checkpoint.packb(
        {"params": tree["params"]})


@pytest.mark.parametrize("family,game", [(f, g) for f in FAMILIES
                                         for g in GAME_PREFIX])
def test_family_model_loads_into_registered_head(family, game):
    path = ROOT / model_path(family, game)
    assert path.exists(), path
    spec = FAMILIES[family]
    assert checkpoint_head(path) == (spec["alg"], spec["network"])
    module = load_eval_params(spec["alg"], spec["network"], path, game,
                              device="cpu")
    assert not module.training
    assert next(module.parameters()).device.type == "cpu"


def _bad_trees():
    good = _tree("Breakout.a2c.model")
    p = good["params"]
    lstm = _tree("Breakout.ppo_lstm.model")["params"]
    return {
        "an unknown trunk (cnn_im2col's names)": {"params": {
            **p, "trunk": {"conv1_kernel": np.zeros((256, 32), np.float32),
                           **p["trunk"]}}},
        "an unknown collection": {**good, "batch_stats": {}},
        "a head too many": {"params": {**p, "Dense_2": p["Dense_1"]}},
        "a Dense without bias": {"params": {
            **p, "Dense_1": {"kernel": p["Dense_1"]["kernel"]}}},
        "an LSTM without its base": {"params": {
            **lstm, "trunk": {k: v for k, v in lstm["trunk"].items()
                              if k != "base"}}},
        "an LSTM gate missing": {"params": {**lstm, "trunk": {
            **lstm["trunk"], "OptimizedLSTMCell_0": {
                k: v for k, v in lstm["trunk"]["OptimizedLSTMCell_0"].items()
                if k != "ig"}}}},
        "no trunk": {"params": {"Dense_0": p["Dense_0"]}},
    }


@pytest.mark.parametrize("case", list(_bad_trees()))
def test_unknown_trees_raise(case):
    with pytest.raises(ValueError):
        checkpoint.params_from_flax(_bad_trees()[case])


def test_params_to_flax_checks_the_template_and_the_keys():
    sd = checkpoint.params_from_flax(_tree("Amidar.deepq.model"))
    assert checkpoint.state_dict_template(sd) == "dueling_q:conv_only"
    with pytest.raises(ValueError, match="not 'pi_v:cnn'"):
        checkpoint.params_to_flax(sd, "pi_v:cnn")
    with pytest.raises(ValueError, match="not in the"):
        checkpoint.params_to_flax({**sd, "extra.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="no eval head"):
        checkpoint_head("models/Breakout.unknown.model")

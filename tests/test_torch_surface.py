"""The rest of the port's surface against the JAX package's, on a CPU
machine (tensorboard, matplotlib and pygame are not on the card's):
``BatchedMonitor.record_info``, ``results_plotter``, the logger's
tensorboard format, ``human_play.keys_to_ale``, and the layout variants
of NatureCNN (``cnn_im2col``, ``cnn_coutpad``) on JAX's own param trees
(the matching parts of tests/test_utils.py and tests/test_rl.py)."""

import csv
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401

INFOS = [  # three batched steps of two envs: NaN marks an env not done
    {"episode_return": np.array([1.0, np.nan], np.float32),
     "episode_length": np.array([10, 0], np.int32)},
    {"episode_return": np.array([np.nan, np.nan], np.float32),
     "episode_length": np.array([0, 0], np.int32)},
    {"episode_return": np.array([2.5, 3.0], np.float32),
     "episode_length": np.array([7, 12], np.int32)},
    {"episode_return": np.array([np.nan, 4.0], np.float32),
     "episode_length": np.array([0, 20], np.int32)},
]


def _rows(path):
    with open(path) as f:
        header = f.readline()
        return header, [(r["r"], r["l"]) for r in csv.DictReader(f)]


def test_record_info_matches_jax(tmp_path):
    from toybox_tpu.utils.monitor import BatchedMonitor as JMon
    from toybox_tpu_torch.utils.monitor import BatchedMonitor, load_results

    mons = [BatchedMonitor(str(tmp_path / "port"), header_extra={"g": 1}),
            JMon(str(tmp_path / "jax"), header_extra={"g": 1})]
    flushed = []
    for i, info in enumerate(INFOS):
        # the port takes the env's tensors as they come off the device
        mons[0].record_info({k: torch.as_tensor(v) for k, v in info.items()})
        mons[1].record_info(info)
        flushed.append(len(_rows(tmp_path / "port.monitor.csv")[1]))
    assert flushed == [1, 1, 3, 4]          # one flush a call that ended any
    assert mons[0].episode_rewards == mons[1].episode_rewards
    assert mons[0].episode_lengths == mons[1].episode_lengths == [10, 7, 12,
                                                                  20]
    for m in mons:
        m.close()
    (ph, pr), (jh, jr) = (_rows(tmp_path / f"{n}.monitor.csv")
                          for n in ("port", "jax"))
    assert pr == jr and '"g": 1' in ph and '"g": 1' in jh
    assert [e["r"] for e in load_results(str(tmp_path / "port.monitor.csv"))
            ] == [1.0, 2.5, 3.0, 4.0]


def test_results_plotter_matches_jax(tmp_path):
    from toybox_tpu import results_plotter as jrp
    from toybox_tpu_torch import results_plotter as prp
    from toybox_tpu_torch.utils.monitor import BatchedMonitor

    mon = BatchedMonitor(str(tmp_path / "run0"))
    for info in INFOS:
        mon.record_info(info)
    mon.close()
    eps = prp.load_monitor_dir(str(tmp_path))
    assert eps == jrp.load_monitor_dir(str(tmp_path))
    assert [e["r"] for e in eps] == [1.0, 2.5, 3.0, 4.0]
    for xaxis in prp.X_AXES:
        for a, b in zip(prp.episodes_to_xy(eps, xaxis),
                        jrp.episodes_to_xy(eps, xaxis)):
            np.testing.assert_array_equal(a, b)
    x, y = prp.episodes_to_xy(eps, "timesteps")
    np.testing.assert_allclose(x, [10, 17, 29, 49])
    np.testing.assert_array_equal(prp.running_mean(y, window=2),
                                  jrp.running_mean(y, window=2))
    assert prp.truncate_to_timesteps(eps, 25) == \
        jrp.truncate_to_timesteps(eps, 25)
    assert len(prp.truncate_to_timesteps(eps, 25)) == 2
    out = tmp_path / "curves.png"
    prp.plot_results([str(tmp_path)], xaxis="episodes", title="t",
                     out=str(out))
    assert out.exists() and out.stat().st_size > 0
    out2 = tmp_path / "cli.png"
    prp.main(["--dirs", str(tmp_path), "--out", str(out2)])
    assert out2.exists()


def test_tensorboard_format_writes_the_logged_scalars(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    from toybox_tpu_torch.utils import logger

    lg = logger.configure(dir=str(tmp_path), format_strs=["tensorboard"])
    assert isinstance(lg.output_formats[0], logger.TensorBoardOutputFormat)
    for i in range(3):
        logger.logkv("loss", 0.5 * i)
        logger.logkv("fps", 100 + i)
        logger.logkv("name", "text")         # not a scalar: skipped
        logger.dumpkvs()
    lg.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == ["fps", "loss"]
    loss = acc.Scalars("loss")
    assert [e.step for e in loss] == [1, 2, 3]
    assert [e.value for e in loss] == [0.0, 0.5, 1.0]
    assert [e.value for e in acc.Scalars("fps")] == [100.0, 101.0, 102.0]


def test_keys_to_ale_matches_jax_on_every_key_combination():
    from toybox_tpu.human_play import keys_to_ale as jkeys
    from toybox_tpu_torch.human_play import keys_to_ale

    seen = set()
    for keys in itertools.product([False, True], repeat=5):
        a = keys_to_ale(*keys)
        assert a == jkeys(*keys), keys
        seen.add(a)
    assert len(seen) == 18                   # every ALE action reachable


LAYOUT_NETS = ("cnn_im2col", "cnn_coutpad")


@pytest.mark.parametrize("network", LAYOUT_NETS)
def test_layout_cnn_matches_jax_on_its_param_tree(network):
    """JAX's pi + V head over the trunk, initialised by flax and carried
    over: the port's forward within 1e-5 at batch 2 of 84x84x4, and the
    tree written back unchanged."""
    from toybox_tpu.rl.models import get_network_builder as jbuilder
    from toybox_tpu.rl.policies import PolicyWithValue as JPolicy
    from toybox_tpu_torch.rl.checkpoint import (flax_template,
                                                params_from_flax,
                                                params_to_flax,
                                                state_dict_template)
    from toybox_tpu_torch.rl.models import network_factory
    from toybox_tpu_torch.rl.policies import PolicyWithValue

    obs = np.random.default_rng(0).integers(0, 256, (2, 84, 84, 4),
                                            dtype=np.uint8)
    jnet = JPolicy(trunk=jbuilder(network)(), n_pdparams=4)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    want = [np.asarray(x) for x in jnet.apply(variables, jnp.asarray(obs))]
    tree = jax.tree_util.tree_map(np.asarray, variables)
    assert flax_template(tree) == f"pi_v:{network}"
    module = PolicyWithValue(network_factory(network)((84, 84, 4)), 4)
    module.load_state_dict(params_from_flax(tree))
    assert state_dict_template(module.state_dict()) == f"pi_v:{network}"
    with torch.no_grad():
        got = [x.numpy() for x in module(torch.from_numpy(obs))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    back = params_to_flax(module.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("network", LAYOUT_NETS)
def test_layout_cnn_is_natures_function(network):
    """Each variant computes NatureCNN's function on the same weights
    (the im2col product in JAX's window order; the padded output channels
    sliced away), and trains through build_policy."""
    from toybox_tpu_torch.rl.models import NatureCNN, init_trunk, \
        network_factory
    from toybox_tpu_torch.rl.policies import build_policy

    nature = NatureCNN()
    init_trunk(nature, torch.Generator().manual_seed(1))
    net = network_factory(network)((84, 84, 4))
    sd = nature.state_dict()
    if network == "cnn_coutpad":
        net.load_state_dict({k.replace("conv0", "c1").replace(
            "conv1", "c2").replace("conv2", "c3"): v for k, v in sd.items()})
    else:
        # conv0's OIHW kernel -> the im2col rows in (kh, kw, c) order
        w = sd["conv0.weight"].permute(0, 2, 3, 1).reshape(32, -1)
        net.load_state_dict({"conv1.weight": w, "conv1.bias": sd[
            "conv0.bias"], "conv_0.weight": sd["conv1.weight"],
            "conv_0.bias": sd["conv1.bias"], "conv_1.weight": sd[
                "conv2.weight"], "conv_1.bias": sd["conv2.bias"],
            "fc.weight": sd["fc.weight"], "fc.bias": sd["fc.bias"]})
    obs = torch.randint(0, 256, (3, 84, 84, 4), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(net(obs), nature(obs), rtol=1e-5,
                                   atol=1e-5)
    module, init_fn, step_fn, value_fn = build_policy(
        (84, 84, 4), 4, network, device="cpu")
    init_fn(0)
    actions, values, _, _ = step_fn(obs, torch.Generator().manual_seed(0))
    assert actions.shape == (3,) and torch.isfinite(values).all()

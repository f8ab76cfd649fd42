"""The JAX package's public names in the port.

- An ``ast`` walk (no imports) over every pair of same-path modules:
  every public top-level name of the JAX module (a def, a class, an
  assignment; in an ``__init__.py`` also a name imported from the
  package) is bound at the top level of the port's module, apart from
  EXEMPT, each entry with the ROADMAP.md §1 item (or hazard) that keeps it
  out; and the JAX modules with no counterpart are exactly
  NOT_PORTED_MODULES.
- Each name added to an already ported module computes JAX's function on
  the same inputs (numpy seed 0), or is an alias of the port's
  counterpart.
"""

import ast
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "toybox_tpu", ROOT / "toybox_tpu_torch"

#: (module, name) -> why the port does not have it
EXEMPT = {
    # jnp dtype aliases: the port holds u32 words in int64 (ROADMAP
    # hazards, RNG dtype), so it has no such aliases
    ("games/common.py", "I32"): "hazards: RNG dtype",
    ("games/common.py", "U32"): "hazards: RNG dtype",
    ("games/common.py", "BOOL"): "hazards: RNG dtype",
    ("rl/acer.py", "I32"): "hazards: RNG dtype",
    ("rl/ddpg.py", "I32"): "hazards: RNG dtype",
    ("rl/dqn.py", "I32"): "hazards: RNG dtype",
    ("rl/ppo1.py", "I32"): "hazards: RNG dtype",
}
#: the JAX modules with no counterpart in the port, and why
NOT_PORTED_MODULES = {
    "ops/render_pallas.py": "ported as ops/render_cuda.py, render_si.py "
                            "and render_amidar.py over csrc/*.cu",
}


def _public(path: Path) -> set:
    """The JAX module's public top-level names."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(x.id for t in targets for x in ast.walk(t)
                         if isinstance(x, ast.Name))
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and (node.level or (node.module or "").startswith(
                  "toybox_tpu"))):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _bound(path: Path) -> set:
    """Every name bound at the port module's top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(x.id for t in targets for x in ast.walk(t)
                         if isinstance(x, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def test_every_public_name_of_each_module_pair_is_ported():
    missing, unported = [], set()
    for jpath in sorted(JAX_PKG.rglob("*.py")):
        rel = jpath.relative_to(JAX_PKG).as_posix()
        ppath = PORT_PKG / rel
        if not ppath.exists():
            unported.add(rel)
            continue
        missing += [(rel, n) for n in sorted(_public(jpath) - _bound(ppath))
                    if (rel, n) not in EXEMPT]
    assert not missing, f"public names the port lacks: {missing}"
    assert unported == set(NOT_PORTED_MODULES)
    # every exemption still names something the port lacks
    for rel, name in EXEMPT:
        assert name in _public(JAX_PKG / rel)
        assert name not in _bound(PORT_PKG / rel), (rel, name)


def test_core_names_match_jax():
    import toybox_tpu.core as jcore
    import toybox_tpu_torch.core as pcore
    from toybox_tpu.core import actions as ja, jsonutil as jj, rng as jr
    from toybox_tpu.core import types as jt
    from toybox_tpu_torch.core import actions as pa, jsonutil as pj, \
        rng as pr, types as pt

    for name in ("ACTION_LOOKUP", "ACTION_MEANING", "LEGAL_ACTIONS"):
        assert getattr(pcore, name) == getattr(jcore, name)
    assert pcore.actions is pa and pcore.rng is pr and pcore.types is pt
    assert pcore.jsonutil is pj and pcore.ale_to_input is pa.ale_to_input
    assert pa.BUTTON1_STR == ja.BUTTON1_STR
    for a in range(18):
        jin, pin = ja.ale_to_input(jnp.asarray(a)), pa.ale_to_input(
            torch.tensor(a))
        assert pa.input_to_ale(pin) == ja.input_to_ale(jin) == a
    assert pa.input_to_ale(pt.Input(left=True, right=True)) == \
        ja.input_to_ale(jt.Input(left=True, right=True)) == 0
    for k in ("Up", "Down", "Left", "Right", "ALL", "CODE", "FROM_CODE",
              "VECTORS"):
        assert getattr(pt.Direction, k) == getattr(jt.Direction, k)
    assert pcore.Direction is pt.Direction and pt.DIRECTIONS == \
        jt.DIRECTIONS
    np.testing.assert_array_equal(pt.rgba(1, 2, 3).numpy(),
                                  np.asarray(jt.rgba(1, 2, 3)))
    # jsonutil
    for x in (np.float32(1.5), np.int64(3), np.bool_(True),
              np.array(5, np.uint8), np.str_("x")):
        assert pj.pyval(x) == jj.pyval(x)
        assert type(pj.pyval(x)) is type(jj.pyval(x))
    assert pj.pyval(torch.tensor(2.5)) == 2.5
    tree = {"a": [np.int32(1), (np.float64(2.0),)], "b": np.bool_(False)}
    assert json.dumps(pj.sanitize(tree)) == json.dumps(jj.sanitize(tree))
    v = np.array([1.25, -3.5], np.float32)
    assert pj.vec2d_to_json(v) == jj.vec2d_to_json(v)
    np.testing.assert_array_equal(pj.vec2d_from_json({"x": 1.0, "y": 2.0}),
                                  jj.vec2d_from_json({"x": 1.0, "y": 2.0}))
    # rng.bernoulli: the same state and bits as JAX's
    seeds = np.arange(6, dtype=np.uint32) * 977
    js, ps = jr.seed(jnp.asarray(seeds)), pr.seed(torch.as_tensor(
        seeds.astype(np.int64)))
    for p in (0.1, 0.5, 0.9):
        js, jb = jr.bernoulli(js, p)
        ps, pb = pr.bernoulli(ps, p)
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(ps.numpy(),
                                      np.asarray(js).astype(np.int64))


def test_games_names_match_jax():
    from toybox_tpu import games as jg
    from toybox_tpu.games import amidar as jam, common as jc
    from toybox_tpu.games import space_invaders as jsi
    from toybox_tpu_torch import games as pg
    from toybox_tpu_torch.games import amidar as pam, common as pc
    from toybox_tpu_torch.games import space_invaders as psi

    pg.register_game("breakout_copy", pg.breakout)
    try:
        assert pg.get_game("breakout_copy") is pg.breakout
    finally:
        del pg.GAMES["breakout_copy"]
    assert "breakout_copy" not in jg.GAMES
    assert psi.N_SHIELDS == jsi.N_SHIELDS == len(
        psi.default_config("cpu").shield_pos)
    r = np.random.default_rng(0)
    tiles = r.integers(0, 30, (5, 2)).astype(np.int32)
    np.testing.assert_array_equal(pam.tile_to_world(tiles).numpy(),
                                  np.asarray(jam.tile_to_world(tiles)))
    world = r.integers(-40, 2000, (7, 2)).astype(np.int32)
    np.testing.assert_array_equal(pam.world_to_tile(world).numpy(),
                                  np.asarray(jam.world_to_tile(world)))
    np.testing.assert_array_equal(
        pc.circle_mask(12, 10, 4.5, 6.25, 3.0).numpy(),
        np.asarray(jc.circle_mask(12, 10, 4.5, 6.25, 3.0)))
    img = r.integers(0, 256, (12, 10, 4)).astype(np.uint8)
    mask = r.random((12, 10)) < 0.3
    np.testing.assert_array_equal(
        pc.paint(torch.as_tensor(img), torch.as_tensor(mask),
                 [9, 8, 7, 255]).numpy(),
        np.asarray(jc.paint(jnp.asarray(img), jnp.asarray(mask),
                            [9, 8, 7, 255])))
    xywh = np.array([[1, 2, 4, 3], [2.5, 0, 3, 6], [0, 0, 2, 2]],
                    np.float32)
    colors = r.integers(0, 256, (3, 4)).astype(np.uint8)
    alive = np.array([True, True, False])
    np.testing.assert_array_equal(
        pc.paint_rects(torch.as_tensor(img), xywh, colors, alive).numpy(),
        np.asarray(jc.paint_rects(jnp.asarray(img), xywh, colors, alive)))
    np.testing.assert_array_equal(
        pc.to_grayscale(torch.as_tensor(img)).numpy(),
        np.asarray(jc.to_grayscale(jnp.asarray(img))))


def test_run_and_runner_names():
    from toybox_tpu import run as jrun
    from toybox_tpu_torch import run as prun
    from toybox_tpu_torch.games import breakout
    from toybox_tpu_torch.sample_tests.runner import env_config

    assert prun.GAME_IDS == jrun.GAME_IDS
    cfg = breakout.default_config("cpu")
    assert env_config(breakout, cfg) is cfg
    assert env_config(breakout, None, "cpu").device == torch.device("cpu")


def test_obs_ops_match_jax():
    from toybox_tpu.ops import obs as jo
    from toybox_tpu_torch.ops import obs as po

    r = np.random.default_rng(0)
    for shape, fn in (((2, 210, 160, 3), "warp_frame"),
                      ((3, 40, 30), "warp_frame2d")):
        x = r.integers(0, 256, shape, dtype=np.uint8)
        got = getattr(po, fn)(torch.as_tensor(x)).numpy().astype(int)
        want = np.asarray(getattr(jo, fn)(jnp.asarray(x))).astype(int)
        assert got.shape == want.shape
        # the matmuls sum in another order than jax.image.resize: within
        # one grey level (ROADMAP hazards, warp summation order)
        assert np.abs(got - want).max() <= 1
        assert (got != want).mean() < 0.01
    a, b = (r.integers(0, 256, (2, 5, 5, 1), dtype=np.uint8)
            for _ in range(2))
    np.testing.assert_array_equal(
        po.max_pool_pair(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jo.max_pool_pair(a, b)))
    stack = po.reset_frame_stack(torch.as_tensor(a), 4)
    np.testing.assert_array_equal(stack.numpy(),
                                  np.asarray(jo.reset_frame_stack(a, 4)))
    np.testing.assert_array_equal(
        po.push_frame_stack(stack, torch.as_tensor(b)).numpy(),
        np.asarray(jo.push_frame_stack(jo.reset_frame_stack(a, 4), b)))


def test_model_registry_names():
    from toybox_tpu.rl import models as jm
    from toybox_tpu_torch.rl import models as pm

    ported = set(jm._REGISTRY)
    assert set(pm.NETWORKS) == ported
    for name in ported:
        assert pm.get_network_builder(name) is getattr(pm, name) is \
            pm.network_factory(name)
    assert pm.get_network_builder(pm.mlp) is pm.mlp
    assert type(pm.cnn((84, 84, 4))) is pm.NatureCNN
    assert pm.cnn_small((28, 28, 1)).latent == 128
    assert pm.lstm((3,), nlstm=8, num_hidden=4).latent == 8
    assert isinstance(pm.CNNLSTMCarry, type)

    @pm.register("tiny_mlp")
    def tiny_mlp(obs_shape, **kw):
        return pm.MLP(math.prod(obs_shape), num_hidden=2)

    try:
        assert pm.get_network_builder("tiny_mlp")((3,)).latent == 2
    finally:
        del pm.NETWORKS["tiny_mlp"]
    assert type(pm.get_network_builder("cnn_im2col")((84, 84, 4))) is \
        pm.Im2ColCNN
    assert type(pm.cnn_coutpad((84, 84, 4))) is pm.CoutPadCNN
    with pytest.raises(ValueError, match="cnn_im2col"):
        pm.get_network_builder("cnn_unknown")


def test_recurrent_learner_names():
    from toybox_tpu_torch.rl import a2c, acer
    from toybox_tpu_torch.rl.policies import pd_from_logits
    from toybox_tpu_torch.rl.test_envs import make_fixed_sequence_env

    assert a2c.RecurrentA2CState is a2c.A2CState
    assert acer.RecurrentACERState is acer.ACERState
    assert acer.RecurrentTrajReplay is acer.TrajReplay
    assert pd_from_logits(3, torch.zeros(2, 3)).logits.shape == (2, 3)
    env = make_fixed_sequence_env(4, n_actions=3, episode_len=4,
                                  device="cpu")
    with pytest.raises(ValueError, match="not recurrent"):
        acer.make_recurrent_acer(env, network="mlp", device="cpu")
    init_fn, cycle = acer.make_recurrent_acer(
        env, network="lstm", nlstm=8, nsteps=2, replay_ratio=1,
        buffer_traj=2, network_kwargs=dict(num_hidden=8), device="cpu")
    state = init_fn(0)
    state, metrics = cycle(state)
    assert isinstance(state, acer.RecurrentACERState)
    assert state.carry[0].shape == (4, 8) and state.replay.masks is not None
    assert all(bool(torch.isfinite(v)) for k, v in metrics.items()
               if k in acer.METRICS)


def test_logger_names(tmp_path):
    """tests/test_rl.py:192 (test_logger) in the port, and the rest of
    the surface: levels, log, get_dir, ProfileKV, profile."""
    from toybox_tpu.utils import logger as jl
    from toybox_tpu_torch.utils import logger

    for k in ("DEBUG", "INFO", "WARN", "ERROR", "DISABLED"):
        assert getattr(logger, k) == getattr(jl, k)
    lg = logger.configure(dir=str(tmp_path), format_strs=["csv", "json",
                                                          "log"])
    assert logger.get_dir() == str(tmp_path)
    lg.logkv("a", 1.0)
    lg.logkv_mean("b", 2.0)
    logger.logkv_mean("b", 4.0)
    out = lg.dumpkvs()
    assert out["b"] == 3.0
    lg.logkv("a", 2.0)
    lg.logkv("c", 1.0)  # a new key rewrites the csv header
    lg.dumpkvs()
    csvf = (tmp_path / "progress.csv").read_text().splitlines()
    assert csvf[0].split(",")[0] in ("a", "b", "c")
    assert len(csvf) == 3
    logger.log("shown")
    logger.log("hidden", level=logger.DEBUG)
    with logger.ProfileKV("block"):
        pass

    @logger.profile("fn")
    def fn():
        return 7

    assert fn() == 7
    assert {"wait_block", "wait_fn"} <= set(lg.name2val)
    lg.set_level(logger.DISABLED)
    assert lg.dumpkvs() == {}
    lg.close()
    text = (tmp_path / "log.txt").read_text()
    assert "shown" in text and "hidden" not in text
    assert all(isinstance(w, logger.KVWriter) for w in lg.output_formats)
    assert isinstance(lg.output_formats[2], logger.SeqWriter)
    assert issubclass(logger.TensorBoardOutputFormat, logger.KVWriter)
    assert set(logger._WRITERS) == set(jl._WRITER_FACTORIES)

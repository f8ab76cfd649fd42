"""The single-env policy adapter against the JAX package's: the port's
``make_tb_policy`` on the port's facade and JAX's on JAX's, from the same
seed and the same action script (each adapter's own draws ignored). The
engines stay bit-equal (state JSON); the frames each adapter renders
equal ``luma2d(render)`` exactly; the stacks agree within 1 grey level on
under 1 % of their pixels (the port warps with the pipeline's two f32
matmuls, the JAX adapter with ``jax.image.resize``: the same weights
summed in another order, as tests/test_torch_pipeline.py allows); the
heads' outputs on JAX's stacks agree within the heads' tolerance
(tests/test_torch_heads.py). Recurrent networks raise, as in JAX."""

import numpy as np
import pytest
import torch

import toybox_tpu
import toybox_tpu_torch
from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_heads import N_ACT, _jax_module, _jax_params, \
    assert_close
from toybox_tpu.games import get_game as j_get_game
from toybox_tpu.games.common import luma2d as j_luma2d
from toybox_tpu.rl import eval_adapter as j_adapter
from toybox_tpu_torch.core.actions import LEGAL_ACTIONS
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.rl.eval_adapter import load_eval_params, \
    make_tb_policy

MACRO_STEPS = 6
CASES = [("breakout", "Breakout.a2c", "a2c", "cnn"),
         ("space_invaders", "SpaceInvaders.acer", "acer", "cnn_small"),
         ("amidar", "Amidar.deepq", "deepq", "conv_only")]


def _jax_state(action_fn) -> dict:
    """The JAX adapter's closure state (its stack and captured frame)."""
    cells = dict(zip(action_fn.__code__.co_freevars,
                     (c.cell_contents for c in action_fn.__closure__)))
    return cells["state"]


def _jax_frame(tb) -> np.ndarray:
    module = j_get_game(tb.game_name)
    return np.asarray(j_luma2d(module.render(tb.rsimulator.config,
                                             tb.rstate.tree)))


@pytest.mark.parametrize("game,name,alg,network", CASES,
                         ids=[c[0] for c in CASES])
def test_tb_policy_matches_jax(game, name, alg, network):
    path = f"models/{name}.model"
    params = _jax_params(name, alg, network, game)
    j_fn = j_adapter.make_tb_policy(alg, network, params, game, seed=0)
    t_fn = make_tb_policy(alg, network, load_state_dict(path), game,
                          seed=0, device="cpu")
    legal = np.asarray(LEGAL_ACTIONS[game])
    script = np.random.default_rng(3).choice(legal, 4 * MACRO_STEPS)
    script[::5] = 1                                  # FIRE often
    j_apply = _jax_module(alg, network, N_ACT[game]).apply
    head = load_eval_params(alg, network, path, game, device="cpu")
    jtb = toybox_tpu.Toybox(game, seed=0)
    ttb = toybox_tpu_torch.Toybox(game, seed=0, device="cpu")
    for i, a in enumerate(script):
        j_act, t_act = j_fn(jtb), t_fn(ttb)
        assert t_act in legal and j_act in legal
        js, ts = _jax_state(j_fn), t_fn.state
        if i % 4 == 3:
            frame = _jax_frame(jtb)
            np.testing.assert_array_equal(ts["g1"].numpy(), frame)
            np.testing.assert_array_equal(np.asarray(js["g1"]), frame)
        if i % 4 == 0:
            stack = np.asarray(js["stack"])
            diff = np.abs(ts["stack"].numpy().astype(int) - stack)
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, i
            obs = np.moveaxis(stack, 0, -1)[None]
            want = j_apply(params, obs)
            with torch.no_grad():
                got = head(torch.as_tensor(obs.copy()))
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            for g, w in zip(got, want):
                assert_close(g, w, f"{name} head at frame {i}")
        jtb.apply_ale_action(int(a))
        ttb.apply_ale_action(int(a))
        if i % 4 == 3:
            assert ttb.to_state_json() == jtb.to_state_json(), i
    assert t_fn.state["frame"] == 4 * MACRO_STEPS
    t_fn.reset()
    assert t_fn.state["stack"] is None and t_fn.state["frame"] == 0


def test_tb_policy_plays_a_fresh_game_after_reset():
    fn = make_tb_policy("ppo", "cnn", None, "breakout", seed=1,
                        device="cpu")
    tb = toybox_tpu_torch.Toybox("breakout", seed=0, device="cpu")
    for _ in range(8):
        tb.apply_ale_action(fn(tb))
    tb.new_game()
    fn.reset()
    first = fn(tb)
    assert first in LEGAL_ACTIONS["breakout"]
    assert torch.equal(fn.state["stack"][0], fn.state["stack"][3])


@pytest.mark.parametrize("network", ["cnn_lstm", "cnn_lnlstm", "lstm"])
def test_recurrent_network_raises(network):
    with pytest.raises(ValueError, match="feedforward-only"):
        make_tb_policy("ppo", network, None, "breakout", device="cpu")

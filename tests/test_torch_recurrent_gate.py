"""The gate loops with recurrent heads on the CPU, at a tiny depth: the
port's ``regress.play_games`` and ``sample_tests.runner.play_batched``
play the committed cnn_lstm / cnn_lnlstm checkpoints, and one chunk of
``play_games`` threads the LSTM carry as the JAX package's recurrent head
does: fed the frames and ``prev_done`` flags the port's loop fed its head
(a game over forced on env 0 mid-chunk), JAX's head gives the same
logits, values and carry at every step, within the heads' tolerance
(tests/test_torch_heads.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_heads import _jax_module, _jax_params, assert_close
from toybox_tpu_torch import regress
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.sample_tests import get_scenarios
from toybox_tpu_torch.sample_tests import runner

CHUNK, FORCED = 16, 5


def test_play_games_threads_the_carry_as_jax(monkeypatch):
    rec = {k: [] for k in ("obs", "prev_done", "value", "carry", "done")}
    make_rl_env = regress.make_rl_env
    build = regress.build_eval_head

    def recording_env(*args, **kwargs):
        env = make_rl_env(*args, **kwargs)

        def step(st, actions):
            st, obs, r, done, info = env.step(st, actions)
            if len(rec["done"]) == FORCED:
                done = done | (torch.arange(env.num_envs) == 0)
            rec["done"].append(done.clone())
            return st, obs, r, done, info

        return dataclasses.replace(env, step=step)

    def recording_head(*args, **kwargs):
        module, p_step = build(*args, **kwargs)

        def step(obs, generator, carry, prev_done):
            out = p_step(obs, generator, carry, prev_done)
            rec["obs"].append(obs.clone())
            rec["prev_done"].append(prev_done.clone())
            rec["value"].append(out[1])
            rec["carry"].append(out[3])
            return out

        rec["module"] = module
        return module, step

    monkeypatch.setattr(regress, "make_rl_env", recording_env)
    monkeypatch.setattr(regress, "build_eval_head", recording_head)
    path = "models/Breakout.a2c_lstm.model"
    scores = regress.play_games("breakout", load_state_dict(path),
                                "cnn_lstm", 2, alg="a2c", device="cpu",
                                chunk=CHUNK, max_frames=4 * CHUNK)
    assert scores.shape == (2,) and np.isfinite(scores).all()
    assert len(rec["obs"]) == CHUNK
    assert not rec["prev_done"][0].any()
    for t in range(1, CHUNK):
        assert torch.equal(rec["prev_done"][t], rec["done"][t - 1]), t
    assert rec["prev_done"][FORCED + 1][0]

    params = _jax_params("Breakout.a2c_lstm", "a2c", "cnn_lstm", "breakout")
    apply = jax.jit(_jax_module("a2c", "cnn_lstm", 4).apply)
    carry = (jnp.zeros((2, 128)), jnp.zeros((2, 128)))
    pi = rec["module"].pi
    for t in range(CHUNK):
        logits, value, carry = apply(params, rec["obs"][t].numpy(), carry,
                                     rec["prev_done"][t].numpy())
        c, h = rec["carry"][t]
        with torch.no_grad():
            assert_close(pi(h), logits, f"logits at step {t}")
        assert_close(rec["value"][t], value, f"value at step {t}")
        assert_close(c, carry[0], f"c at step {t}")
        assert_close(h, carry[1], f"h at step {t}")


def test_play_games_plays_the_lnlstm_checkpoint():
    seen = []
    scores = regress.play_games(
        "space_invaders", load_state_dict(
            "models/SpaceInvaders.ppo_lnlstm.model"), "cnn_lnlstm", 2,
        device="cpu", chunk=CHUNK, max_frames=4 * CHUNK * 2,
        on_chunk=lambda steps, totals: seen.append(steps))
    assert scores.shape == (2,) and np.isfinite(scores).all()
    assert seen == [CHUNK, 2 * CHUNK]


def test_play_batched_plays_the_acer_lstm_checkpoint():
    scenario = get_scenarios("space_invaders")[0](seed=0)
    cfg_js, st_js = runner.capture_setup(scenario, device="cpu")
    scores = runner.play_batched(
        "space_invaders", cfg_js, st_js,
        state_dict=load_state_dict("models/SpaceInvaders.acer_lstm.model"),
        alg="acer", network="cnn_lstm", n_episodes=2, device="cpu",
        chunk=CHUNK, max_frames=4 * CHUNK * 4)
    assert scores.shape == (2,) and np.isfinite(scores).all()
    assert (scores >= 0).all()


def test_regress_cli_names_the_algs_and_networks():
    with pytest.raises(ValueError, match="unknown alg 'nope'.*deepq"):
        regress.main(["--alg=nope"])
    with pytest.raises(ValueError, match="unknown network 'nope'.*cnn_lstm"):
        regress.main(["--alg=acer", "--network=nope", "--device=cpu"])

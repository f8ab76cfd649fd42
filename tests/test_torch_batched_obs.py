"""The port's batched env with observations against the JAX package's:
each game x {grayscale, rgba, rgb} x auto_reset {True, False}, N = 4 envs
and 30 steps from a start where two games end on the first step: obs,
reward, done and info exactly equal. Also the stateful ``BatchedEnv``,
and the pipeline's inner env, which must render nothing."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.envs.batched import BatchedEnv as JBatchedEnv
from toybox_tpu.envs.batched import _make_obs_fn as j_make_obs_fn
from toybox_tpu.envs.batched import make_batched_env as j_make_batched_env
from toybox_tpu.games import get_game as j_get_game
from toybox_tpu_torch.envs import pipeline
from toybox_tpu_torch.envs.batched import BatchedEnv
from toybox_tpu_torch.envs.batched import \
    make_batched_env as t_make_batched_env
from toybox_tpu_torch.games import get_game as t_get_game

GAMES = ("breakout", "space_invaders", "amidar", "gridworld")
MODES = ("grayscale", "rgba", "rgb")
N, STEPS = 4, 30


def _start(game, st, xp):
    """Envs 0 and 2 end on the first step (no lives left; Gridworld: one
    step left of the goal), envs 1 and 3 have one life left. ``xp`` is
    jnp or torch."""
    g = st.game
    if game == "gridworld":
        left_of_goal = xp.asarray(np.array([[6, 5], [2, 4]] * 2, np.int32))
        g = g.replace(player=left_of_goal)
    else:
        g = g.replace(lives=xp.asarray(np.array([0, 1] * 2, np.int32)))
    return dataclasses.replace(st, game=g) if xp is torch else \
        st.replace(game=g)


def _actions(game):
    r = np.random.default_rng(len(game))
    acts = r.integers(0, len(j_get_game(game).LEGAL_ACTIONS), (STEPS, N))
    if game == "gridworld":
        acts[0] = 2     # RIGHT (legal index 2): envs 0 and 2 reach the goal
    return acts


@functools.lru_cache(maxsize=None)
def _jax_obs(game):
    """JAX's obs of every mode from one jitted render a step."""
    module = j_get_game(game)
    cfg = module.default_config()
    fns = [j_make_obs_fn(module, m)[0] for m in MODES]
    return jax.jit(lambda g: {m: jax.vmap(f, in_axes=(None, 0))(cfg, g)
                              for m, f in zip(MODES, fns)})


@functools.lru_cache(maxsize=None)
def _jax_run(game, auto_reset):
    """The JAX env's rollout: (reset obs, [(obs, reward, done, info)]),
    the obs of each mode as JAX's make_batched_env(obs_mode=m) computes
    it (its obs function on the stepped states)."""
    env = j_make_batched_env(game, N, obs_mode="none", auto_reset=auto_reset)
    st, _ = env.reset(jnp.arange(N, dtype=jnp.uint32) + 3)
    obs0 = _jax_obs(game)(st.game)
    st = _start(game, st, jnp)
    step = jax.jit(env.step)
    out = []
    for a in _actions(game):
        st, _, rew, done, info = step(st, jnp.asarray(a, jnp.int32))
        out.append((_jax_obs(game)(st.game), rew, done, info))
    return obs0, jax.device_get(out)


@pytest.mark.parametrize("auto_reset", [True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("game", GAMES)
def test_obs_modes_match_jax(game, mode, auto_reset):
    obs0, jrun = _jax_run(game, auto_reset)
    env = t_make_batched_env(game, N, obs_mode=mode, auto_reset=auto_reset,
                             device="cpu")
    module = t_get_game(game)
    c = {"grayscale": 1, "rgba": 4, "rgb": 3}[mode]
    assert env.obs_shape == (module.HEIGHT, module.WIDTH, c)
    assert env.obs_mode == mode
    st, obs = env.reset(torch.arange(N) + 3)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(obs0[mode]))
    st = _start(game, st, torch)
    dones = 0
    for i, (a, (jobs, jr, jd, ji)) in enumerate(zip(_actions(game), jrun)):
        st, obs, rew, done, info = env.step(st, torch.as_tensor(a))
        assert obs.dtype == torch.uint8
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs[mode]),
                                      err_msg=f"obs at step {i}")
        np.testing.assert_array_equal(rew.numpy(), jr, f"reward {i}")
        np.testing.assert_array_equal(done.numpy(), jd, f"done {i}")
        for k, v in ji.items():
            np.testing.assert_array_equal(info[k].numpy(), v, f"{k} {i}")
        dones += int(done.sum())
    assert dones > 0, "no game ended in the run"
    if not auto_reset:
        assert bool(done.any())    # a finished env stays finished


@pytest.mark.parametrize("game", ["breakout", "gridworld"])
def test_stateful_batched_env_matches_jax(game):
    jenv = JBatchedEnv(game, N, seed=5)
    tenv = BatchedEnv(game, N, seed=5, device="cpu")
    assert tenv.num_actions == jenv.num_actions
    np.testing.assert_array_equal(tenv.reset().numpy(),
                                  np.asarray(jenv.reset()))
    r = np.random.default_rng(2)
    for i in range(10):
        a = r.integers(0, jenv.num_actions, N)
        tout = tenv.step(torch.as_tensor(a))
        jout = jenv.step(a)
        for t, j in zip(tout[:3], jout[:3]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        for k, v in jout[3].items():
            np.testing.assert_array_equal(tout[3][k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(tenv.reset(seed=9).numpy(),
                                  np.asarray(jenv.reset(seed=9)))


def test_pipeline_inner_env_renders_nothing(monkeypatch):
    """make_rl_env builds its inner env with obs_mode="none", and a kernel
    game's pipeline never calls the engine's render (its frames come
    from the frame kernels' plain versions on the CPU)."""
    modes = []

    def spy(*args, **kw):
        modes.append(kw.get("obs_mode", "grayscale"))
        return t_make_batched_env(*args, **kw)

    monkeypatch.setattr(pipeline, "make_batched_env", spy)
    for game in GAMES:
        pipeline.make_rl_env(game, 2, device="cpu")
    assert modes == ["none"] * len(GAMES)

    def refuse(*args):
        raise AssertionError("the pipeline rendered through module.render")

    for game in pipeline.FRAME_KERNEL_GAMES:
        monkeypatch.setattr(t_get_game(game), "render", refuse)
        env = pipeline.make_rl_env(game, 2, device="cpu")
        st, _ = env.reset(torch.arange(2))
        for _ in range(2):
            st, *_ = env.step(st, torch.ones(2, dtype=torch.long))
    with pytest.raises(ValueError, match="unknown obs_mode"):
        t_make_batched_env("breakout", 2, obs_mode="rgbx", device="cpu")

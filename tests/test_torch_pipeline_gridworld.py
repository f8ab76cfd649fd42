"""The port's DeepMind pipeline on Gridworld, the game with no frame
kernel, against the JAX package's non-Pallas pipeline (the max of two
``luma2d(render)`` frames, then the warp) on the default and a
non-default grid; and the port's mirror of tests/test_rl.py's Gridworld
PPO tests (a train step, the save/load round trip) and its CLI."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toybox_tpu.games.gridworld as jgw
from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_gridworld import ALT_CONFIG
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import ppo as jppo
from toybox_tpu_torch import run
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.games import gridworld as tgw
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.policies import build_policy

N, STEPS = 4, 40
# (config JSON or None, the cell left of its goal, where env 0 starts)
CASES = {"default": (None, [6, 5]), "alt": (ALT_CONFIG, [8, 1])}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_jax_non_pallas(name):
    """Rewards, dones, lives and raw rewards equal, observations within 1
    grey level (the warps sum in other orders) over STEPS agent steps of
    random play; env 0 reaches the goal on the first step, so the
    auto-reset and the stack restart run."""
    cfg_js, near_goal = CASES[name]
    jcfg = None if cfg_js is None else jgw.config_from_json(cfg_js)
    tcfg = None if cfg_js is None else tgw.config_from_json(cfg_js, "cpu")
    jenv = j_make_rl_env("gridworld", N, config=jcfg, use_pallas=False)
    tenv = t_make_rl_env("gridworld", N, config=tcfg, device="cpu")
    assert tenv.obs_shape == jenv.obs_shape == (84, 84, 4)
    jst, jobs = jenv.reset(jnp.arange(N, dtype=jnp.uint32))
    tst, tobs = tenv.reset(torch.arange(N))
    assert int(np.abs(np.asarray(jobs, np.int32)
                      - tobs.numpy().astype(np.int32)).max()) <= 1
    start = np.asarray(jst.env.game.player).copy()
    start[0] = near_goal
    jst = jst.replace(env=jst.env.replace(
        game=jst.env.game.replace(player=jnp.asarray(start))))
    tst = dataclasses.replace(tst, env=dataclasses.replace(
        tst.env, game=tst.env.game.replace(player=torch.as_tensor(start))))
    r = np.random.default_rng(8)
    acts = r.integers(0, tenv.num_actions, (STEPS, N))
    acts[0, 0] = 2                               # RIGHT onto the goal
    jstep = jax.jit(jenv.step)
    worst, dones = 0, 0
    for i, a in enumerate(acts):
        jst, jobs, jr, jd, ji = jstep(jst, jnp.asarray(a, jnp.int32))
        tst, tobs, tr, td, ti = tenv.step(tst, torch.as_tensor(a))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), f"{i}")
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), f"{i}")
        for k in ("lives", "raw_reward", "score"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]),
                                          f"{k} {i}")
        worst = max(worst, int(np.abs(np.asarray(jobs, np.int32)
                                      - tobs.numpy().astype(np.int32)).max()))
        dones += int(td.sum())
    assert worst <= 1, worst
    assert dones > 0


def test_inkernel_warp_raises_for_a_game_without_a_kernel():
    with pytest.raises(ValueError, match="gridworld"):
        t_make_rl_env("gridworld", 2, inkernel_warp=True, device="cpu")


def test_ppo_train_step_runs_and_is_finite():
    """tests/test_rl.py::test_ppo_train_step_runs_and_is_finite on the
    port."""
    env = t_make_rl_env("gridworld", 4, device="cpu")
    init_fn, train_step, _ = ppo.make_ppo(
        env, nsteps=8, nminibatches=2, noptepochs=2, network="cnn_small",
        total_updates=10, device="cpu")
    state = init_fn(0)
    for _ in range(2):
        state, metrics = train_step(state)
    for k, v in metrics.items():
        if k in ("eprewmean", "eplenmean"):
            continue
        assert np.isfinite(float(v)), (k, v)
    assert state.update == 2


def test_save_load_roundtrip(tmp_path):
    """tests/test_rl.py::test_save_load_roundtrip on the port, and the
    file read by the JAX package's load_params into its own template."""
    env = t_make_rl_env("gridworld", 2, device="cpu")
    init_fn, _, _ = ppo.make_ppo(env, nsteps=4, nminibatches=1,
                                 noptepochs=1, network="cnn_small",
                                 device="cpu")
    state = init_fn(0)
    path = str(tmp_path / "model.msgpack")
    ppo.save_params(path, state.module)
    module = build_policy(env.obs_shape, env.num_actions, "cnn_small",
                          device="cpu")[0]
    ppo.load_params(path, module)
    for k, v in state.module.state_dict().items():
        assert torch.equal(module.state_dict()[k], v), k
    jinit, _, _ = jppo.make_ppo(j_make_rl_env("gridworld", 2), nsteps=4,
                                nminibatches=1, noptepochs=1,
                                network="cnn_small")
    loaded = jppo.load_params(path, jinit(0).params)
    back = params_from_flax(jax.tree_util.tree_map(np.asarray, loaded))
    for k, v in state.module.state_dict().items():
        assert torch.equal(back[k], v), k


def test_run_main_trains_on_gridworld(tmp_path):
    """``--env=GridWorldToyboxNoFrameskip-v4 --alg=ppo`` trains (the
    matmul-warp pipeline, since Gridworld has no frame kernel)."""
    state = run.main(["--alg=ppo", "--env=GridWorldToyboxNoFrameskip-v4",
                      "--num_envs=2", f"--num_timesteps={2 * 4 * 4 * 2}",
                      "--nsteps=4", "--nminibatches=2", "--noptepochs=1",
                      "--network=cnn_small", "--device=cpu",
                      f"--log_path={tmp_path / 'log'}",
                      f"--save_path={tmp_path / 'gw.model'}"])
    assert state.update == 2
    assert (tmp_path / "gw.model").stat().st_size > 0

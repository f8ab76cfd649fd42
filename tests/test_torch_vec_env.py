"""The port's VecEnv surface (envs/vec_env.py) on the CPU: the vec-env
cases of tests/test_harnesses.py on the port (Dummy == Batched, Dummy ==
Subproc == Shmem, frame stack + monitor, normalize, running mean/std),
the batched executor equal to JAX's, and the refusal of envs on cuda in
forked workers."""

import dataclasses

import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from tests.test_harnesses import _CountingEnv  # noqa: E402
from tests.test_torch_codecs import one_torch_thread  # noqa: E402,F401
from toybox_tpu.envs import vec_env as jvec  # noqa: E402
from toybox_tpu_torch.envs import vec_env  # noqa: E402
from toybox_tpu_torch.envs.atari import BreakoutEnv  # noqa: E402
from toybox_tpu_torch.envs.vec_env import (BatchedVecEnv,  # noqa: E402
                                           DummyVecEnv, RunningMeanStd,
                                           ShmemVecEnv, SubprocVecEnv,
                                           VecFrameStack, VecMonitor,
                                           VecNormalize, make_vec_env)
from toybox_tpu_torch.utils.monitor import load_results  # noqa: E402


def test_vec_env_dummy_equals_batched():
    n = 2
    dummy = DummyVecEnv([lambda: BreakoutEnv(frameskip=1, device="cpu")] * n)
    obs_d = dummy.reset(seed=0)
    batched = BatchedVecEnv("breakout", n, seed=0, device="cpu")
    obs_b = batched.reset()
    assert obs_d.shape == obs_b.shape == (n, 160, 240, 1)
    for venv in (dummy, batched):
        obs, rew, done, infos = venv.step(np.ones(n, np.int64))
        assert obs.shape == (n, 160, 240, 1)
        assert rew.shape == (n,) and done.shape == (n,)
        assert isinstance(infos, list) and len(infos) == n
    dummy.close()


def test_vec_env_dummy_subproc_shmem_consistency():
    n = 3
    fns = [lambda: _CountingEnv() for _ in range(n)]
    venvs = [DummyVecEnv(fns), SubprocVecEnv(fns), ShmemVecEnv(fns)]
    try:
        obs = [v.reset(seed=7) for v in venvs]
        for o in obs[1:]:
            np.testing.assert_array_equal(obs[0], o)
        rng = np.random.RandomState(0)
        for _ in range(12):   # crosses the episode boundary (auto-reset)
            actions = rng.randint(0, 4, size=n)
            results = [v.step(actions) for v in venvs]
            o0, r0, d0, i0 = results[0]
            for o, r, d, infos in results[1:]:
                np.testing.assert_array_equal(o0, o)
                np.testing.assert_array_equal(r0, r)
                np.testing.assert_array_equal(d0, d)
                for a, b in zip(i0, infos):
                    assert a.get("t") == b.get("t")
                    if "terminal_observation" in a:
                        np.testing.assert_array_equal(
                            a["terminal_observation"],
                            b["terminal_observation"])
    finally:
        for v in venvs:
            v.close()


def test_vec_frame_stack_and_monitor(tmp_path):
    """Env 0 starts left of the goal and steps onto it: its episode (10
    points, one step) is in infos and in the monitor file."""
    base = BatchedVecEnv("gridworld", 2, device="cpu")
    venv = VecMonitor(VecFrameStack(base, 4),
                      filename=str(tmp_path / "run"))
    obs = venv.reset()
    assert obs.shape == (2, 112, 144, 4)
    st = base._env.state
    base._env.state = dataclasses.replace(st, game=st.game.replace(
        player=torch.tensor([[6, 5], [2, 4]], dtype=torch.int32)))
    obs, rew, done, infos = venv.step(np.array([2, 0]))      # RIGHT, NOOP
    assert done.tolist() == [True, False]
    assert infos[0]["episode"]["r"] == 10.0
    assert infos[0]["episode"]["l"] == 1 and "episode" not in infos[1]
    assert not obs[0, ..., :3].any()      # the stack restarts on done
    for _ in range(3):
        obs, rew, done, infos = venv.step(np.zeros(2, np.int64))
    assert obs.shape[-1] == 4
    rows = load_results(str(tmp_path / "run.monitor.csv"))
    assert [(r["r"], r["l"]) for r in rows] == [(10.0, 1)]


def test_vec_normalize():
    venv = VecNormalize(BatchedVecEnv("gridworld", 2, device="cpu"))
    obs = venv.reset()
    for _ in range(3):
        obs, rew, done, infos = venv.step(np.zeros(2, np.int64))
    assert np.isfinite(obs).all()
    assert np.abs(obs).max() <= venv.clipob + 1e-6


def test_running_mean_std_matches_jax():
    mine, theirs = RunningMeanStd(shape=()), jvec.RunningMeanStd(shape=())
    data = np.random.default_rng(0).normal(3.0, 2.0, size=(10, 100))
    for batch in data:
        mine.update(batch)
        theirs.update(batch)
    assert (mine.mean, mine.var, mine.count) == (theirs.mean, theirs.var,
                                                 theirs.count)
    assert abs(mine.mean - 3.0) < 0.2
    assert abs(np.sqrt(mine.var) - 2.0) < 0.2


@pytest.mark.parametrize("game", ["breakout", "gridworld"])
def test_batched_vec_env_matches_jax(game):
    """make_vec_env's batched executor (reference id) against the JAX
    package's BatchedVecEnv: obs, rewards, dones and infos equal."""
    env_id = {"breakout": "BreakoutToyboxNoFrameskip-v4",
              "gridworld": "GridWorldToyboxNoFrameskip-v4"}[game]
    mine = make_vec_env(env_id, 3, seed=4, device="cpu")
    theirs = jvec.BatchedVecEnv(game, 3, seed=4)
    np.testing.assert_array_equal(mine.reset(), theirs.reset())
    r = np.random.default_rng(1)
    for _ in range(8):
        a = r.integers(0, mine.action_space.n, 3)
        m, t = mine.step(a), theirs.step(a)
        for x, y in zip(m[:3], t[:3]):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(m[3], t[3]):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


def test_make_vec_env_dummy_executor():
    venv = make_vec_env("GridWorldToyboxNoFrameskip-v4", 2, seed=0,
                        use_batched=False, device="cpu")
    assert isinstance(venv, DummyVecEnv)
    obs = venv.reset(seed=0)
    assert obs.shape == (2, 112, 144, 1)       # make_atari does not warp
    obs, rew, done, infos = venv.step(np.zeros(2, np.int64))
    assert obs.shape == (2, 112, 144, 1) and len(infos) == 2
    venv.close()


def test_forked_workers_refuse_envs_on_cuda(monkeypatch):
    """An env fn whose env lies on cuda is refused before any worker is
    forked (the device test mocked: the build box has no card); with
    context='spawn' the check does not apply."""
    assert vec_env._env_device(BreakoutEnv(device="cpu")) == "cpu"
    assert vec_env._env_device(_CountingEnv()) is None
    monkeypatch.setattr(vec_env, "_env_device", lambda env: "cuda")
    fns = [lambda: _CountingEnv()] * 2
    for cls in (SubprocVecEnv, ShmemVecEnv):
        with pytest.raises(ValueError, match="context='spawn'"):
            cls(fns)
    vec_env._refuse_cuda_fork(_CountingEnv(), "spawn")

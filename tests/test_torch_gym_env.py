"""The port's gymnasium surface (envs/__init__.py, envs/gym.py,
envs/atari/*, envs/wrappers.py) on the CPU: the cases of
tests/test_gym_env.py on the port; each id built by its own package
(the port registers under the ``toybox_tpu_torch`` namespace); and the
port's env and DeepMind stack stepping as JAX's do."""

import numpy as np
import pytest

gym = pytest.importorskip("gymnasium")

import toybox_tpu.envs  # noqa: E402  (registers the JAX package's ids)
import toybox_tpu.envs.atari as jatari  # noqa: E402
import toybox_tpu_torch.envs as tenvs  # noqa: E402
from tests.test_torch_codecs import one_torch_thread  # noqa: E402,F401
from toybox_tpu.envs import wrappers as jwrappers  # noqa: E402
from toybox_tpu_torch.envs.atari import (BreakoutEnv,  # noqa: E402
                                         GridWorldEnv, ToyboxBaseEnv)
from toybox_tpu_torch.envs.gym import get_turtle  # noqa: E402
from toybox_tpu_torch.envs.wrappers import (SampleEnvs,  # noqa: E402
                                            get_complement, hotpatch_ale,
                                            make_atari, wrap_deepmind)

IDS = ("BreakoutToyboxNoFrameskip-v4", "AmidarToyboxNoFrameskip-v4",
       "SpaceInvadersToyboxNoFrameskip-v4", "GridWorldToyboxNoFrameskip-v4")


@pytest.mark.parametrize("env_id", IDS)
def test_each_id_builds_its_own_packages_env(env_id):
    """The reference id builds the JAX package's env, the namespaced one
    the port's, whichever package registered first."""
    assert tenvs.gym_id(env_id) == f"toybox_tpu_torch/{env_id}"
    mine = gym.make(tenvs.gym_id(env_id), device="cpu")
    theirs = gym.make(env_id)
    assert type(mine.unwrapped).__module__ == "toybox_tpu_torch.envs.atari"
    assert type(theirs.unwrapped).__module__ == "toybox_tpu.envs.atari"
    assert type(mine.unwrapped).__name__ == type(theirs.unwrapped).__name__
    assert mine.observation_space == theirs.observation_space
    assert mine.action_space == theirs.action_space
    mine.close()
    theirs.close()


def test_registration_and_make():
    env = gym.make(tenvs.gym_id("BreakoutToyboxNoFrameskip-v4"),
                   device="cpu")
    obs, info = env.reset(seed=42)
    assert obs.shape == (160, 240, 1)
    assert env.action_space.n == 4
    obs, rew, term, trunc, info = env.step(1)
    assert "lives" in info and "score" in info
    env.close()


def test_reward_is_clamped_score_delta():
    env = BreakoutEnv(frameskip=1, device="cpu")
    env.reset(seed=0)
    env.step(1)
    total = 0.0
    for _ in range(300):
        obs, rew, term, trunc, info = env.step(0)
        assert rew >= 0
        total += rew
        if term:
            break
    assert total > 0, "serve straight up should score"
    env.close()


def test_gridworld_env_and_seed_determinism():
    env = GridWorldEnv(device="cpu")
    obs, info = env.reset(seed=1)
    assert obs.shape == (112, 144, 1) and info["lives"] == 1
    env.close()

    def rollout(seed):
        env = BreakoutEnv(frameskip=1, device="cpu")
        env.reset(seed=seed)
        scores = []
        for _ in range(60):
            _, r, term, _, info = env.step(1)
            scores.append(info["score"])
            if term:
                break
        env.close()
        return scores

    assert rollout(7) == rollout(7)


def test_get_turtle_and_deepmind_stack_shapes():
    env = wrap_deepmind(make_atari("BreakoutToyboxNoFrameskip-v4",
                                   device="cpu"),
                        frame_stack=True, clip_rewards=True)
    turtle = get_turtle(env)
    assert isinstance(turtle, ToyboxBaseEnv) and turtle.ale.lives() > 0
    obs, info = env.reset(seed=3)
    assert np.asarray(obs).shape == (84, 84, 4)
    obs, rew, term, trunc, info = env.step(0)
    assert np.asarray(obs).shape == (84, 84, 4)
    assert rew in (-1.0, 0.0, 1.0)
    env.close()


def test_get_complement_mock_ale_and_hotpatch():
    assert get_complement("BreakoutToyboxNoFrameskip-v4") == \
        "BreakoutNoFrameskip-v4"
    assert get_complement("BreakoutNoFrameskip-v4") == \
        "BreakoutToyboxNoFrameskip-v4"
    assert get_complement("toybox_tpu_torch/BreakoutToyboxNoFrameskip-v4") \
        == "BreakoutNoFrameskip-v4"
    env = BreakoutEnv(device="cpu")
    env.reset(seed=0)
    assert env.ale.lives() == 5 and env.ale.get_score() == 0
    assert not env.ale.game_over()
    assert env.get_action_meanings()[0] == "NOOP"
    env.close()
    try:
        import ale_py  # noqa: F401
    except ImportError:
        assert hotpatch_ale() is False
        with pytest.raises(ImportError, match="ale_py"):
            make_atari("BreakoutNoFrameskip-v4")


def test_sample_envs_mixing_weights():
    a = BreakoutEnv(frameskip=1, device="cpu")
    b = BreakoutEnv(frameskip=1, device="cpu")
    env = SampleEnvs([a, b], [1.0, 0.0])
    for _ in range(3):
        env.reset(seed=0)
        assert env.current is a
        env.step(0)
    env.close()


def _assert_same_step(mine, theirs, where):
    for m, t in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(m), np.asarray(t), where)


@pytest.mark.parametrize("cls", ["BreakoutEnv", "GridWorldEnv"])
def test_env_steps_as_jax(cls):
    """The default frameskip draw, obs, reward, flags and info of each
    step equal to the JAX env's from the same seed."""
    import toybox_tpu_torch.envs.atari as tatari

    mine = getattr(tatari, cls)(device="cpu")
    theirs = getattr(jatari, cls)()
    _assert_same_step(mine.reset(seed=11)[:1], theirs.reset(seed=11)[:1],
                      "reset")
    r = np.random.default_rng(0)
    for i in range(40):
        a = int(r.integers(mine.action_space.n))
        m, t = mine.step(a), theirs.step(a)
        _assert_same_step(m[:4], t[:4], f"step {i}")
        assert m[4] == t[4], i


def test_deepmind_stack_steps_as_jax():
    mine = wrap_deepmind(make_atari("BreakoutToyboxNoFrameskip-v4",
                                    device="cpu"), frame_stack=True)
    theirs = jwrappers.wrap_deepmind(
        jwrappers.make_atari("BreakoutToyboxNoFrameskip-v4"),
        frame_stack=True)
    _assert_same_step(mine.reset(seed=3)[:1], theirs.reset(seed=3)[:1],
                      "reset")
    for i in range(25):
        _assert_same_step(mine.step(i % 4)[:4], theirs.step(i % 4)[:4],
                          f"step {i}")

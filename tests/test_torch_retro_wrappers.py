"""The port's retro wrappers (toybox_tpu_torch/envs/retro_wrappers.py)
against the JAX package's: the cases of tests/test_retro_wrappers.py,
each wrapper of both packages over the same inner env and actions, with
the same outputs; the retro-only entry point fails loudly in both."""

import numpy as np
import pytest

gym = pytest.importorskip("gymnasium")

from gymnasium import spaces  # noqa: E402

import toybox_tpu.envs.retro_wrappers as jrw  # noqa: E402
import toybox_tpu_torch.envs.retro_wrappers as prw  # noqa: E402
from tests.test_torch_codecs import one_torch_thread  # noqa: E402,F401


class CountingEnv(gym.Env):
    """Frame pixels = step count; reward = +1 per step."""

    def __init__(self, shape=(8, 8, 3)):
        self.observation_space = spaces.Box(0, 255, shape, np.uint8)
        self.action_space = spaces.Discrete(4)
        self.t = 0
        self.actions = []

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self.t = 0
        self.actions = []
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        self.actions.append(int(action))
        return self._obs(), 1.0, False, False, {}

    def _obs(self):
        return np.full(self.observation_space.shape, self.t % 256, np.uint8)


def _same(a, b, where=""):
    """Equal gymnasium step or reset outputs (arrays, dicts, scalars)."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
        assert np.asarray(a).dtype == np.asarray(b).dtype, where


def _pair(build, actions, seed=0, **kw):
    """Both packages' wrapper over their own inner env: the reset and
    every step's outputs equal; returns the two wrapped envs."""
    envs = [build(mod, **kw) for mod in (prw, jrw)]
    outs = [e.reset(seed=seed) for e in envs]
    _same(outs[0], outs[1], "reset")
    for i, a in enumerate(actions):
        outs = [e.step(a) for e in envs]
        _same(outs[0], outs[1], f"step {i}")
    return envs


def test_time_limit_truncates():
    def build(m):
        return m.TimeLimit(CountingEnv(), max_episode_steps=5)

    port, _ = _pair(build, [0] * 5)
    port.reset()
    assert not port.step(0)[3]            # the counter resets
    _pair(build, [0] * 7)                 # past the limit too


@pytest.mark.parametrize("stickprob", [1.0, 0.0, 0.25])
def test_stochastic_frameskip_skips_and_sticks(stickprob):
    def build(m):
        env = m.StochasticFrameSkip(CountingEnv(), n=4, stickprob=stickprob)
        env.rng = np.random.default_rng(7)
        return env

    port, jax_env = _pair(build, [1, 2, 3, 0, 2])
    assert port.unwrapped.actions == jax_env.unwrapped.actions
    assert port.unwrapped.t == 20


def test_partial_frame_stack_channels():
    port, _ = _pair(lambda m: m.PartialFrameStack(CountingEnv(), k=3,
                                                  channel=1), [0, 1, 2, 3])
    assert port.observation_space.shape == (8, 8, 5)


def test_downsample_and_rgb2gray():
    _pair(lambda m: m.Downsample(CountingEnv(shape=(16, 16, 3)), ratio=2),
          [0, 1, 2])
    port, _ = _pair(lambda m: m.Rgb2gray(CountingEnv()), [0, 1, 2])
    assert port.observation_space.shape == (8, 8, 1)


class Swingy(CountingEnv):
    REWS = [3.0, -2.0, 1.0, 5.0]

    def step(self, action):
        obs, _, term, trunc, info = super().step(action)
        return obs, self.REWS[(self.t - 1) % 4], term, trunc, info


def test_reward_scaler_and_allow_backtracking():
    _pair(lambda m: m.RewardScaler(CountingEnv(), scale=0.5), [0, 1])
    envs = [m.AllowBacktracking(Swingy()) for m in (prw, jrw)]
    for e in envs:
        e.reset(seed=0)
    got = [[e.step(0)[1] for _ in range(8)] for e in envs]
    assert got[0] == got[1]
    assert got[0][:4] == [3.0, 0.0, 0.0, 4.0]


def test_append_timeout_dict_obs():
    port, _ = _pair(lambda m: m.AppendTimeout(
        m.TimeLimit(CountingEnv(), max_episode_steps=4)), [0, 1, 2])
    assert set(port.observation_space.spaces) == {
        "original", "value_estimation_timeout"}


def test_sonic_discretizer_buttons():
    class MultiBinaryEnv(CountingEnv):
        def __init__(self):
            super().__init__()
            self.action_space = spaces.MultiBinary(12)

    assert prw.SonicDiscretizer.BUTTONS == jrw.SonicDiscretizer.BUTTONS
    envs = [m.SonicDiscretizer(MultiBinaryEnv()) for m in (prw, jrw)]
    assert envs[0].action_space.n == envs[1].action_space.n == 7
    for a in range(7):
        np.testing.assert_array_equal(envs[0].action(a), envs[1].action(a))


def test_make_retro_fails_loudly_without_retro():
    for m in (prw, jrw):
        with pytest.raises(ImportError, match="retro"):
            m.make_retro(game="SonicTheHedgehog-Genesis")


def test_stack_composes_on_toybox_env():
    """The generic stack over each package's own Toybox gym env steps
    alike (the same sticky draws)."""
    import toybox_tpu.envs  # noqa: F401  (registers the JAX package's ids)
    import toybox_tpu_torch.envs as tenvs

    def build(m):
        env_id = "BreakoutToyboxNoFrameskip-v4"
        env = (gym.make(tenvs.gym_id(env_id), device="cpu") if m is prw
               else gym.make(env_id))
        env = m.StochasticFrameSkip(env, n=4, stickprob=0.25)
        env.rng = np.random.default_rng(3)
        env = m.TimeLimit(env, max_episode_steps=8)
        return m.RewardScaler(env, scale=0.1)

    actions = np.random.default_rng(0).integers(0, 4, 8).tolist()
    port, jax_env = _pair(build, actions)
    for e in (port, jax_env):
        e.close()

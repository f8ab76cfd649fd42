"""The port's DeepMind pipeline against the JAX one (XLA path): same seeds
and numpy actions give the same reward, done and lives, and observations
within 1 grey level (the warp's f32 matmuls may sum in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch ops here are small: one intra-op thread does them as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("episodic_life,clip", [(True, True), (False, False)])
def test_pipeline_matches_jax(episodic_life, clip):
    n, steps = 4, 40
    r = np.random.default_rng(11)
    acts = r.choice(4, size=(steps, n), p=[.2, .4, .2, .2])
    seeds = np.arange(n, dtype=np.uint32) + 3
    jenv = j_make_rl_env("breakout", n, use_pallas=False,
                         episodic_life=episodic_life, clip_rewards=clip)
    tenv = t_make_rl_env("breakout", n, episodic_life=episodic_life,
                         clip_rewards=clip, device="cpu")
    assert tuple(tenv.obs_shape) == tuple(jenv.obs_shape)
    assert tenv.num_actions == jenv.num_actions
    jst, jo = jax.jit(jenv.reset)(jnp.asarray(seeds))
    tst, to = tenv.reset(torch.as_tensor(seeds.astype(np.int64)))
    assert tuple(to.shape) == (n, 84, 84, 4) and to.dtype == torch.uint8
    assert np.abs(np.asarray(jo).astype(int) - to.numpy()).max() <= 1
    jstep = jax.jit(jenv.step)
    total = 0.0
    for i in range(steps):
        jst, jo, jr, jd, ji = jstep(jst, jnp.asarray(acts[i]))
        tst, to, tr, td, ti = tenv.step(tst, torch.as_tensor(acts[i]))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti["lives"].numpy(),
                                      np.asarray(ji["lives"]))
        np.testing.assert_array_equal(ti["raw_reward"].numpy(),
                                      np.asarray(ji["raw_reward"]))
        diff = np.abs(np.asarray(jo).astype(int) - to.numpy().astype(int))
        assert diff.max() <= 1, f"step {i}: obs differ by {diff.max()}"
        total += float(np.asarray(ji["raw_reward"]).sum())
    assert total > 0
    np.testing.assert_array_equal(tst.lives.numpy(), np.asarray(jst.lives))


@pytest.mark.parametrize("game,steps", [("space_invaders", 64),
                                        ("amidar", 40)])
def test_pipeline_matches_jax_other_games(game, steps):
    """Space Invaders (210 x 320) and Amidar (250 x 160) frames through
    their frame kernels' plain versions and the widened warp."""
    n = 3
    r = np.random.default_rng(12)
    seeds = np.arange(n, dtype=np.uint32) + 5
    jenv = j_make_rl_env(game, n, use_pallas=False)
    tenv = t_make_rl_env(game, n, device="cpu")
    assert tuple(tenv.obs_shape) == tuple(jenv.obs_shape)
    assert tenv.num_actions == jenv.num_actions
    acts = r.integers(0, tenv.num_actions, size=(steps, n))
    jst, jo = jax.jit(jenv.reset)(jnp.asarray(seeds))
    tst, to = tenv.reset(torch.as_tensor(seeds.astype(np.int64)))
    assert np.abs(np.asarray(jo).astype(int) - to.numpy()).max() <= 1
    jstep = jax.jit(jenv.step)
    total = 0.0
    for i in range(steps):
        jst, jo, jr, jd, ji = jstep(jst, jnp.asarray(acts[i]))
        tst, to, tr, td, ti = tenv.step(tst, torch.as_tensor(acts[i]))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti["lives"].numpy(),
                                      np.asarray(ji["lives"]))
        np.testing.assert_array_equal(ti["raw_reward"].numpy(),
                                      np.asarray(ji["raw_reward"]))
        diff = np.abs(np.asarray(jo).astype(int) - to.numpy().astype(int))
        assert diff.max() <= 1, f"step {i}: obs differ by {diff.max()}"
        total += float(np.asarray(ji["raw_reward"]).sum())
    assert total > 0


@pytest.mark.parametrize("game,steps", [("breakout", 30),
                                        ("space_invaders", 30),
                                        ("amidar", 30)])
def test_inkernel_warp_matches_out_of_kernel_and_pallas(game, steps):
    """``inkernel_warp=True`` (the fused kernel's warp form, its plain
    version here) against the port's matmul warp and against the JAX
    pipeline with the Pallas kernels in interpret mode and their in-kernel
    warp: rewards, done and lives equal, observations within 1 grey
    level."""
    n = 2
    r = np.random.default_rng(13)
    seeds = np.arange(n, dtype=np.uint32) + 7
    jenv = j_make_rl_env(game, n, use_pallas=True, inkernel_warp=True)
    envs = {w: t_make_rl_env(game, n, inkernel_warp=w, device="cpu")
            for w in (True, False)}
    acts = r.integers(0, envs[True].num_actions, size=(steps, n))
    acts[::5] = 1
    jst, jo = jax.jit(jenv.reset)(jnp.asarray(seeds))
    tst = {w: e.reset(torch.as_tensor(seeds.astype(np.int64)))[0]
           for w, e in envs.items()}
    jstep = jax.jit(jenv.step)
    worst = {"jax": 0, "matmul": 0}
    differ = {"jax": 0, "matmul": 0}
    for i in range(steps):
        jst, jo, jr, jd, ji = jstep(jst, jnp.asarray(acts[i]))
        out = {}
        for w, e in envs.items():
            tst[w], o, rew, d, info = e.step(tst[w], torch.as_tensor(acts[i]))
            out[w] = (o.numpy().astype(int), rew.numpy(), d.numpy(),
                      info["lives"].numpy())
        for w in (True, False):
            np.testing.assert_array_equal(out[w][1], np.asarray(jr))
            np.testing.assert_array_equal(out[w][2], np.asarray(jd))
            np.testing.assert_array_equal(out[w][3], np.asarray(ji["lives"]))
        for name, ref in (("jax", np.asarray(jo).astype(int)),
                          ("matmul", out[False][0])):
            diff = np.abs(out[True][0] - ref)
            worst[name] = max(worst[name], int(diff.max()))
            differ[name] += int((diff > 0).sum())
    print(f"{game}: in-kernel warp vs JAX Pallas max {worst['jax']} "
          f"({differ['jax']} obs pixels), vs matmul warp max "
          f"{worst['matmul']} ({differ['matmul']} obs pixels)")
    assert worst["jax"] <= 1 and worst["matmul"] <= 1

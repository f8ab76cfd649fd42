"""Whole serve trajectories of the port against the JAX package: the
committed regress models played through both stacks at the regress
settings (``make_rl_env(game, 2, episodic_life=False,
clip_rewards=False)``, env seeds ``arange(2) + seed``, the key schedule of
``toybox_tpu.regress.play_games``), the same Gumbel noise fed to both
policies at every step.

JAX draws ``key, akey = split(key)`` per step and samples
``argmax(logits + gumbel(akey))``, which is ``jax.random.categorical``;
the port takes the same noise through ``distributions.gumbel_max``. The
actions and raw rewards must be equal at every step.

The two pipelines may differ by 1 grey level where a warp sum lands next
to a half-integer (tests/test_torch_pipeline.py), so the two policies see
observations that can differ by 1/255 in a few pixels and their logits by
a little: up to 1.6e-3 over the first 864 agent steps of the full Amidar
gate (10 games, seed 0). A step where the actions differ is then a near
tie: JAX's top two ``logits + g`` lie within NEAR_TIE of each other and
within twice the largest logit difference of the two policies at that
step (the least difference that can reorder them), and that difference is
below LOGIT_NOISE. Such a flip ends the comparison without failing (the
games go apart after it, by chance, not by a fault), as long as at least
MIN_COMPARED of the agent steps were compared before it: at seed 0 both
games follow JAX for all 200, so an early flip, even within a near tie,
means the port changed. Any other divergence fails, and the test reports
the first step where it happens.

Run as a script, it plays a longer comparison and prints where it ends:

    PYTHONPATH=. python tests/test_torch_trajectory.py amidar 10 3000

(the game, the number of games, the most agent steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl.policies import build_policy as j_build_policy
from toybox_tpu.rl.ppo import load_params as j_load_params
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.rl.distributions import gumbel_max
from toybox_tpu_torch.rl.policies import build_eval_policy

MODELS = "models"
N_GAMES = 2
NEAR_TIE = 5e-3
LOGIT_NOISE = 1e-2
MIN_COMPARED = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch ops here are small: one intra-op thread does them as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trajectories(game, model, steps, seed, n_games=N_GAMES):
    """Play both stacks side by side; returns (the first step whose
    actions differ or None, its diagnostics, steps compared, total raw
    reward)."""
    jenv = j_make_rl_env(game, n_games, episodic_life=False,
                         clip_rewards=False)
    tenv = t_make_rl_env(game, n_games, episodic_life=False,
                         clip_rewards=False, device="cpu")
    jmodule, p_init, _, _ = j_build_policy(jenv.obs_shape,
                                           jenv.num_actions, "cnn")
    params = j_load_params(f"{MODELS}/{model}",
                           p_init(jax.random.PRNGKey(0)))
    module, _ = build_eval_policy("ppo", tenv.obs_shape, tenv.num_actions,
                                  "cnn", device="cpu")
    module.load_state_dict(load_state_dict(f"{MODELS}/{model}"))

    j_apply = jax.jit(lambda p, o: jmodule.apply(p, o)[0])
    j_step = jax.jit(jenv.step)
    jst, _ = jax.jit(jenv.reset)(
        jnp.arange(n_games, dtype=jnp.uint32) + jnp.uint32(seed))
    tst, _ = tenv.reset(torch.arange(n_games) + seed)
    key = jax.random.PRNGKey(seed)
    total = 0.0
    for i in range(steps):
        key, akey = jax.random.split(key)
        jlogits = j_apply(params, jst.frames)
        g = jax.random.gumbel(akey, jlogits.shape, jnp.float32)
        ja = jnp.argmax(jlogits + g, axis=-1)
        with torch.no_grad():
            tlogits, _ = module(tst.frames)
        ta = gumbel_max(tlogits, torch.as_tensor(np.array(g)))
        if not np.array_equal(np.asarray(ja), ta.numpy()):
            z = np.sort(np.asarray(jlogits + g), axis=-1)
            env = int(np.argmax(np.asarray(ja) != ta.numpy()))
            margin = float(z[env, -1] - z[env, -2])
            diff = float(np.abs(np.asarray(jlogits)
                                - tlogits.numpy()).max())
            return i, dict(env=env, margin=margin, logit_diff=diff), i, total
        jst, _, _, _, ji = j_step(jst, ja)
        tst, _, _, _, ti = tenv.step(tst, ta)
        jr = np.asarray(ji["raw_reward"])
        np.testing.assert_array_equal(
            ti["raw_reward"].numpy(), jr,
            err_msg=f"{game}: raw rewards differ at agent step {i}")
        total += float(jr.sum())
    return None, {}, steps, total


@pytest.mark.parametrize("game,model,steps", [
    ("amidar", "Amidar.regress.model", 200),
    ("space_invaders", "SpaceInvaders.regress.model", 200)])
def test_serve_trajectory_follows_jax(game, model, steps):
    first, why, compared, total = _trajectories(game, model, steps, seed=0)
    print(f"{game}: compared {compared} agent steps, raw reward {total}; "
          f"first divergence {first} {why}")
    assert compared >= MIN_COMPARED, (
        f"{game}: the trajectories went apart at agent step {first} "
        f"({why}), before {MIN_COMPARED} of the {steps} steps")
    if first is not None:
        assert why["margin"] < NEAR_TIE and why["logit_diff"] < LOGIT_NOISE \
            and why["margin"] <= 2 * why["logit_diff"], (
                f"{game}: actions differ at agent step {first} (env "
                f"{why['env']}) with a margin of {why['margin']:.3g} between "
                f"the top two logits + noise, max logit difference "
                f"{why['logit_diff']:.3g}: not a near tie")


if __name__ == "__main__":
    import sys
    import time

    game, n_games, n_steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    models = {"amidar": "Amidar.regress.model",
              "space_invaders": "SpaceInvaders.regress.model",
              "breakout": "Breakout.regress.model"}
    t0 = time.perf_counter()
    first, why, compared, total = _trajectories(game, models[game], n_steps,
                                                seed=0, n_games=n_games)
    print(f"{game}, {n_games} games, seed 0: actions and raw rewards equal "
          f"for {compared} agent steps (raw reward {total}); first "
          f"divergence {first} {why}; {time.perf_counter() - t0:.0f} s")

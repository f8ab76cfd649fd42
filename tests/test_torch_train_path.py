"""The training path past game overs and over several updates.

- The port's DeepMind pipeline against the JAX one, as the training builds
  it (``make_rl_env``, the fast auto-reset), with games that start with 3
  lives, until every env has finished two games: rewards, dones, lives,
  the finished games' return and length, the reseed counters and every
  engine field equal after every step, observations within 1 grey level
  (the warp's f32 matmuls may sum in another order).
- scripts/train_path_vs_cpu.py, which holds the card's training path
  against the CPU's, run with the CPU against itself at a tiny size: no
  difference and no flip, so that its code cannot rot unrun; and its
  microbatched-update part on the CPU.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.games import breakout as j_breakout
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.games import breakout as t_breakout

ROOT = Path(__file__).resolve().parents[1]
NENVS, LIVES, GAMES, MAX_STEPS = 8, 3, 2, 400
RANDOM_STEPS = 40          # random actions first, then FIRE only


def _train_path():
    spec = importlib.util.spec_from_file_location(
        "train_path_vs_cpu", ROOT / "scripts" / "train_path_vs_cpu.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module       # dataclasses look it up there
    spec.loader.exec_module(module)
    return module


tp = _train_path()


def test_pipeline_past_game_overs_matches_jax():
    jcfg = j_breakout.default_config().replace(
        start_lives=jnp.asarray(LIVES, jnp.int32))
    tcfg = t_breakout.config_from_json(
        dict(t_breakout.config_to_json(t_breakout.default_config("cpu")),
             start_lives=LIVES), device="cpu")
    jenv = j_make_rl_env("breakout", NENVS, config=jcfg)
    tenv = t_make_rl_env("breakout", NENVS, config=tcfg, device="cpu")
    seeds = np.arange(NENVS, dtype=np.uint32) + 3
    jst, _ = jax.jit(jenv.reset)(jnp.asarray(seeds))
    tst, _ = tenv.reset(torch.as_tensor(seeds.astype(np.int64)))
    jstep = jax.jit(jenv.step)
    r = np.random.default_rng(21)
    games = np.zeros(NENVS, int)
    grey = 0
    for i in range(MAX_STEPS):
        a = (r.integers(0, tenv.num_actions, NENVS) if i < RANDOM_STEPS
             else np.ones(NENVS, np.int64))
        reseeds = tst.env.seeds
        jst, jo, jr, jd, ji = jstep(jst, jnp.asarray(a))
        tst, to, tr, td, ti = tenv.step(tst, torch.as_tensor(a))
        where = f"step {i}"
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), where)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), where)
        for k in ("lives", "episode_return", "episode_length"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]),
                                          f"{k} {where}")
        np.testing.assert_array_equal(
            tst.env.seeds.numpy(), np.asarray(jst.env.seeds).astype(np.int64),
            f"reseeds {where}")
        for f in t_breakout.FIELDS:
            j = np.asarray(getattr(jst.env.game, f))
            np.testing.assert_array_equal(
                getattr(tst.env.game, f).numpy(),
                j.astype(np.int64) if j.dtype == np.uint32 else j,
                f"{f} {where}")
        grey = max(grey, int(np.abs(np.asarray(jo).astype(int)
                                    - to.numpy().astype(int)).max()))
        games += (tst.env.seeds != reseeds).numpy()
        if (games >= GAMES).all():
            break
    print(f"{i + 1} steps, games an env {games.tolist()}, observations "
          f"{grey} grey levels apart")
    assert (games >= GAMES).all(), games
    assert grey <= 1


@pytest.mark.parametrize("actions,warp", [("random", "kernel"),
                                          ("random", "matmul"),
                                          ("model", "kernel")])
def test_env_harness_cpu_against_itself(actions, warp):
    r = tp.e1(actions, warp, n=4, steps=30, device="cpu", ref="cpu",
              lives=1, log=lambda s: None)
    assert r["first_difference"] is None and r["grey_max"] == 0, r
    assert r["steps"] == 30, r
    # the random script loses lives, the model scores
    assert r["life_losses" if actions == "random" else "top_score"] > 0, r
    assert not tp.faults([r], None)


def test_train_step_harness_cpu_against_itself():
    """E2 at 2 envs x 8 steps, 2 updates: the CPU fed its own draws is
    itself (no difference, no flip); the perturbed run moves."""
    r = tp.e2(n=2, nsteps=8, updates=2, device="cpu", ref="cpu",
              log=lambda s: None)
    for row in r["rows"]:
        assert row["card_vs_ref"] == 0 and not row["flips"], row
        assert row["card_vs_card_"] > 0, row
        np.testing.assert_equal(row["metrics card"], row["metrics ref"])
        rollout = row["card rollout"]
        assert all(rollout[k] for k in ("rewards", "dones", "games",
                                        "actions", "engine")), rollout
        assert rollout["grey_max"] == 0 and rollout["value_diff"] == 0
    assert not tp.faults([], r)


def test_update0_harness_cpu_against_itself():
    """``--part update0`` at 4 envs x 8 steps with the CPU on both sides:
    the same arm again is itself, half the threads is float order, and
    the rule finds no fault."""
    r = tp.update0(n=4, nsteps=8, device="cpu", ref="cpu",
                   log=lambda s: None)
    assert not r["fault"], r
    assert r["loss_rel"]["card - ref"] == 0 == r["grad_rel"]["card - ref"]
    assert r["update"]["card - ref"]["all"] == 0, r["update"]
    assert r["update"]["card again - card"]["all"] == 0, r["update"]
    assert r["moved"] > 1e-4
    assert r["update"]["ref, half the threads - ref"]["all"] \
        < 0.05 * r["moved"], r["update"]


def test_microbatches_harness_on_the_cpu():
    """``--part microbatches`` at 4 envs x 8 steps: the chunked sums and
    the other row orders are float order apart from the whole minibatch
    (within the rule's bounds; the same update again is itself), every
    sound arm moves the strong weights by far less than the update does,
    and each planted fault by far more."""
    r = tp.microbatches(n=4, nsteps=8, device="cpu", log=lambda s: None)
    assert not r["fault"], r
    assert r["loss_rel"]["mb1 again - mb1"] == 0 \
        == r["grad_rel"]["mb1 again - mb1"]
    assert r["update"]["mb1 again - mb1"]["all"] == 0, r["update"]
    assert r["update"]["mb2 again - mb2"]["all"] == 0, r["update"]
    assert r["moved"] > 1e-4
    planted = {f"mb2 {p} - mb1" for p in tp.PLANTS}
    assert max(v for k, v in r["share"].items() if k not in planted) \
        < 0.05, r["share"]
    assert min(r["share"][k] for k in planted) > 0.2, r["share"]
    assert set(r["arms"]) == {"mb1", "mb1 again", "mb1 reversed",
                              "mb1 shuffled", "mb1'", "mb2", "mb2 again",
                              "mb4", "mb2 chunk normalised",
                              "mb2 chunk dropped"}

"""The port's behavioral gate against the JAX package's: the registry and
the family overrides are equal; every scenario's set-up captured by the
port equals the JAX capture; ``reset_to`` from a captured state plays the
same per-env states as the JAX pipeline (see tests/test_torch_gate_*.py);
the batched env's auto-reset after ``reset_to`` gives JAX's full
reference result even where the fast path keeps step-constant fields;
``run_scenario``, the smoke mode and the CLI run on the CPU."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import toybox_tpu.sample_tests as j_st
import toybox_tpu.sample_tests.families as j_fam
from tests.test_torch_codecs import (assert_fields_equal,  # noqa: F401
                                     one_torch_thread)
from toybox_tpu.envs.batched import make_batched_env as j_make_batched_env
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.games import get_game as j_get_game
from toybox_tpu.sample_tests.runner import capture_setup as j_capture_setup
from toybox_tpu_torch import sample_tests as t_st
from toybox_tpu_torch.envs.batched import make_batched_env
from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.games import get_game as t_get_game
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.sample_tests import families as t_fam
from toybox_tpu_torch.sample_tests import runner
from toybox_tpu_torch.sample_tests.__main__ import main as cli_main

GAMES = ("breakout", "space_invaders", "amidar")
N_ENVS, AGENT_STEPS = 3, 6


def _scenario_attrs(cls):
    return {k: v for k, v in vars(cls).items()
            if not k.startswith("_") and not callable(v)}


@pytest.mark.parametrize("game", GAMES)
def test_registry_equals_jax(game):
    j_sc, t_sc = j_st.get_scenarios(game), t_st.get_scenarios(game)
    assert [c.__name__ for c in t_sc] == [c.__name__ for c in j_sc]
    for jc, tc in zip(j_sc, t_sc):
        s_j, s_t = jc(seed=3), tc(seed=3)
        for k in ("game", "n_episodes", "max_frames", "needs_control"):
            assert getattr(s_t, k) == getattr(s_j, k), (tc.__name__, k)
        assert _scenario_attrs(tc) == _scenario_attrs(jc), tc.__name__
        for scores, control in (([0, 0], [0, 0]), ([120, 60], [200, 90]),
                                ([900, 1], [300, 500])):
            assert s_t.check(scores, control) == s_j.check(scores, control)
    assert t_fam.FAMILIES == j_fam.FAMILIES
    assert t_fam.OVERRIDES == j_fam.OVERRIDES
    assert t_fam.model_path("ppo", game) == j_fam.model_path("ppo", game)


@pytest.mark.parametrize("game", GAMES)
def test_capture_setup_equals_jax(game):
    for jc, tc in zip(j_st.get_scenarios(game), t_st.get_scenarios(game)):
        for seed in (0, 5):
            assert (runner.capture_setup(tc(seed=seed), device="cpu")
                    == j_capture_setup(jc(seed=seed))), (tc.__name__, seed)


# -- reset_to trajectories (run per game by tests/test_torch_gate_*.py) -----

@functools.lru_cache(maxsize=None)
def _envs(game, cfg_key):
    """The JAX pipeline (XLA frames), jitted, and the port's, for one
    config; scenarios that share a config share them."""
    cfg_js = json.loads(cfg_key)
    jmod, tmod = j_get_game(game), t_get_game(game)
    jcfg = jmod.config_from_json(cfg_js)
    jenv = j_make_rl_env(game, N_ENVS, config=jcfg, episodic_life=False,
                         clip_rewards=False, use_pallas=False)
    tcfg = tmod.config_from_json(cfg_js, "cpu")
    tenv = make_rl_env(game, N_ENVS, config=tcfg, episodic_life=False,
                       clip_rewards=False, device="cpu")
    return (jcfg, jax.jit(functools.partial(jenv.reset_to, reseed=False)),
            jax.jit(jenv.step), tcfg, tenv)


def check_reset_to_trajectory(game, scenario):
    """From the scenario's captured set-up, ``reset_to(reseed=False)`` and
    AGENT_STEPS agent steps of a fixed action script give the same per-env
    state JSON, rewards, done and lives as the JAX pipeline, and
    observations within 1 grey level (the warp's matmuls sum in another
    order, as in tests/test_torch_pipeline.py)."""
    cls = next(c for c in t_st.get_scenarios(game) if c.__name__ == scenario)
    cfg_js, st_js = runner.capture_setup(cls(seed=0), device="cpu")
    jmod, tmod = j_get_game(game), t_get_game(game)
    jcfg, j_reset_to, j_step, tcfg, tenv = _envs(
        game, json.dumps(cfg_js, sort_keys=True))
    seeds = np.arange(N_ENVS, dtype=np.uint32) + 11
    jst, jo = j_reset_to(jmod.state_from_json(jcfg, st_js),
                         jnp.asarray(seeds))
    tst, to = tenv.reset_to(tmod.state_from_json(tcfg, st_js),
                            torch.as_tensor(seeds.astype(np.int64)),
                            reseed=False)
    r = np.random.default_rng(3)
    for i in range(AGENT_STEPS + 1):
        diff = np.abs(np.asarray(jo).astype(int) - to.numpy().astype(int))
        assert diff.max() <= 1, f"{scenario} step {i}: obs differ"
        jgame = jax.tree_util.tree_map(np.asarray, jst.env.game)
        for e in range(N_ENVS):
            want = jmod.state_to_json(
                jcfg, jax.tree_util.tree_map(lambda x: x[e], jgame))
            assert tmod.state_to_json(tcfg, tst.env.game, e) == want, (
                f"{scenario}: env {e} differs after {i} agent steps")
        if i == AGENT_STEPS:
            break
        a = r.integers(0, tenv.num_actions, N_ENVS)
        jst, jo, jr, jd, ji = j_step(jst, jnp.asarray(a))
        tst, to, tr, td, ti = tenv.step(tst, torch.as_tensor(a))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti["lives"].numpy(),
                                      np.asarray(ji["lives"]))


# -- the fast auto-reset after reset_to ----------------------------------

def _doctored_breakout():
    """A Breakout state in play with one life, its ball falling past the
    paddle, and step-constant fields that new_game writes otherwise."""
    jmod = j_get_game("breakout")
    cfg = jmod.default_config()
    js = jmod.state_to_json(cfg, jmod.new_game(cfg, seed=4))
    js.update(lives=1, is_dead=False, reset=False, paddle_width=40.0,
              paddle_speed=6.0, ball_radius=3.0)
    js["paddle"]["position"]["x"] = 40.0
    js["balls"] = [{"position": {"x": 200.0, "y": 120.0},
                    "velocity": {"x": 0.0, "y": 2.0}}]
    for b in js["bricks"][:6]:
        b["points"], b["destructible"] = 50, False
    return js


def test_auto_reset_after_reset_to_resets_step_constant_fields():
    """After reset_to from a state whose step-constant fields differ from
    new_game's, the port's fast auto-reset gives the JAX package's full
    (reference) auto-reset: paddle_width, brick points and so on go back
    to new_game's. The JAX fast path keeps them (the case this guards)."""
    js = _doctored_breakout()
    jmod, tmod = j_get_game("breakout"), t_get_game("breakout")
    jcfg, tcfg = jmod.default_config(), tmod.default_config("cpu")
    n, noop = 2, np.zeros(2, np.int32)
    seeds = np.array([8, 9], np.uint32)
    tenv = make_batched_env("breakout", n, config=tcfg, obs_mode="none",
                            fast_auto_reset=True, device="cpu")
    tst, _ = tenv.reset_to(tmod.state_from_json(tcfg, js),
                           torch.as_tensor(seeds.astype(np.int64)),
                           reseed=False)
    assert not tst.constants_fresh
    jstates = {}
    for fast in (False, True):
        env = j_make_batched_env("breakout", n, config=jcfg,
                                 obs_mode="none", fast_auto_reset=fast)
        jstates[fast] = env.reset_to(jmod.state_from_json(jcfg, js),
                                     jnp.asarray(seeds), reseed=False)[0]
        jstates[fast, "step"] = jax.jit(env.step)
    resets = 0
    for i in range(60):
        for fast in (False, True):
            jstates[fast], _, _, jd, _ = jstates[fast, "step"](
                jstates[fast], jnp.asarray(noop))
        tst, _, _, td, _ = tenv.step(tst, torch.as_tensor(noop))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert_fields_equal(tmod, jstates[False].game, tst.game,
                            batched=True, where=f"at frame {i}")
        resets += int(td.sum())
    assert resets == n
    # the JAX fast path kept the injected values; the reference did not
    assert float(jstates[True].game.paddle_width[0]) == 40.0
    assert float(tst.game.paddle_width[0]) == 24.0


def test_pipeline_auto_reset_after_reset_to_matches_full_reference():
    """The same through the pipeline (its inner env takes the fast path):
    after an auto-reset every game state equals the JAX batched env's full
    auto-reset stepped 4 frames a step; a pipeline started by reset keeps
    the fast path (the training path)."""
    js = _doctored_breakout()
    jmod, tmod = j_get_game("breakout"), t_get_game("breakout")
    jcfg, tcfg = jmod.default_config(), tmod.default_config("cpu")
    n = 2
    seeds = np.array([8, 9], np.uint32)
    jenv = j_make_batched_env("breakout", n, config=jcfg, obs_mode="none")
    jst = jenv.reset_to(jmod.state_from_json(jcfg, js), jnp.asarray(seeds),
                        reseed=False)[0]
    j_step = jax.jit(jenv.step)
    tenv = make_rl_env("breakout", n, config=tcfg, device="cpu")
    assert tenv.reset(torch.arange(n))[0].env.constants_fresh
    tst, _ = tenv.reset_to(tmod.state_from_json(tcfg, js),
                           torch.as_tensor(seeds.astype(np.int64)),
                           reseed=False)
    for i in range(20):
        for _ in range(4):
            jst = j_step(jst, jnp.zeros(n, jnp.int32))[0]
        tst = tenv.step(tst, torch.zeros(n, dtype=torch.int64))[0]
        assert_fields_equal(tmod, jst.game, tst.env.game, batched=True,
                            where=f"after {i + 1} agent steps")
    assert (tst.env.game.paddle_width == 24.0).all()


def test_reset_to_reseeds_each_env():
    tmod = t_get_game("breakout")
    tcfg = tmod.default_config("cpu")
    env = make_batched_env("breakout", 3, config=tcfg, obs_mode="none",
                           device="cpu")
    tree = tmod.new_game(tcfg, torch.tensor([5]))
    st, _ = env.reset_to(tree, torch.tensor([1, 2, 3]))
    assert len({tuple(r) for r in st.game.rng.tolist()}) == 3
    st, _ = env.reset_to(tree, torch.tensor([1, 2, 3]), reseed=False)
    assert (st.game.rng == tree.rng).all()
    assert dataclasses.replace(st, constants_fresh=True).constants_fresh


# -- run_scenario, smoke, CLI ------------------------------------------------

@pytest.mark.parametrize("game,scenario", [
    ("breakout", "PolarStarts"), ("space_invaders", "ShieldXs"),
    ("amidar", "EnemyRemoval")])
def test_run_scenario_with_the_ppo_model_on_cpu(game, scenario):
    cls = next(c for c in t_st.get_scenarios(game)
               if c.__name__ == scenario)
    sd = load_state_dict(t_fam.model_path("ppo", game))
    out = runner.run_scenario(
        cls, state_dict=sd, episodes=2, max_frames=100, device="cpu",
        control_cache={}, overrides=t_fam.overrides_for("ppo", game))
    assert len(out["scores"]) == 2 and np.isfinite(out["scores"]).all()
    assert len(out["control"]) == 2 and np.isfinite(out["control"]).all()
    assert isinstance(out["passed"], bool) and out["seconds"] > 0


def test_run_all_gated_shares_controls_and_waives():
    sd = load_state_dict(t_fam.model_path("ppo", "breakout"))
    calls = []
    res = runner.run_all_gated(
        "breakout", state_dict=sd, episodes=1, max_frames=40, device="cpu",
        overrides={"LastBrick": {"waived": "test"}},
        on_result=lambda name, r: calls.append(name))
    assert calls == ["EZChannel", "LastBrick", "PolarStarts"]
    assert res["LastBrick"]["passed"] is None
    assert res["LastBrick"]["waived"] == "test"
    assert res["EZChannel"]["control"] == res["PolarStarts"]["control"]


def test_smoke_mode_matches_jax():
    """run_all plays each scenario per frame through the facade with the
    seeded random policy: the same scores as the JAX package's."""
    for game in GAMES:
        want = j_st.run_all(game, episodes=1, seed=2, max_frames=30)
        got = t_st.run_all(game, episodes=1, seed=2, max_frames=30,
                           device="cpu")
        assert got == want, game


def test_cli_gates_ppo_and_refuses_what_is_not_ported(capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["space_invaders", "--family=ppo", "--device=cpu",
                  "--episodes=1", "--max-frames=40"])
    assert e.value.code == 1        # too short to pass the checks
    out = capsys.readouterr().out
    assert "FAIL NoShields" in out and "BEHAVIORAL REGRESSION" in out
    # every family gates now (a2c at this depth fails its checks), and a
    # recurrent network plays; what the port does not know raises
    with pytest.raises(SystemExit) as e:
        cli_main(["breakout", "--family=a2c", "--device=cpu",
                  "--episodes=1", "--max-frames=40"])
    assert e.value.code == 1
    assert "FAIL EZChannel" in capsys.readouterr().out
    scores = runner.play_batched("breakout", None, None, state_dict=None,
                                 alg="ppo", network="cnn_lstm",
                                 n_episodes=1, device="cpu", chunk=4,
                                 max_frames=16)
    assert np.isfinite(scores).all()
    # JAX's nlstm: a narrower recurrent head's weights load strictly
    from toybox_tpu_torch.rl.policies import build_eval_head
    narrow = build_eval_head("ppo", (84, 84, 4), 4, "cnn_lstm", nlstm=16,
                             device="cpu")[0]
    scores = runner.play_batched("breakout", None, None,
                                 state_dict=narrow.state_dict(), alg="ppo",
                                 network="cnn_lstm", n_episodes=1,
                                 device="cpu", chunk=4, max_frames=16,
                                 nlstm=16)
    assert np.isfinite(scores).all()
    with pytest.raises(ValueError, match="unknown family"):
        cli_main(["breakout", "--family=nope", "--device=cpu"])
    with pytest.raises(ValueError, match="unknown alg 'nope'.*a2c"):
        cli_main(["breakout", "--alg=nope", "--device=cpu",
                  "--load_path=models/Breakout.a2c.model"])
    with pytest.raises(ValueError, match="unknown network.*cnn_small"):
        cli_main(["breakout", "--alg=a2c", "--network=nope",
                  "--device=cpu", "--load_path=models/Breakout.a2c.model"])
    cli_main(["breakout", "--device=cpu", "--episodes=1",
              "--max-frames=20"])
    assert "SMOKE EZChannel" in capsys.readouterr().out

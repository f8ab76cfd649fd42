"""Batched behavioral-scenario runner: the acceptance gate (port of
toybox_tpu.sample_tests.runner).

A scenario's intervention is applied once, through the intervention API,
on one facade handle; the config and state it produces are captured as
JSON, and every episode starts from that state through the pipeline's
``reset_to`` (each env's engine rng reseeded, so that episodes differ).
Play then goes as in ``regress.play_games``: all episodes in parallel on
the DeepMind pipeline (the frame kernels), actions sampled from the
policy with a seeded generator, one host sync per chunk of agent steps.

Pass/fail comes from the scenario's ``check(scores, control=...)``;
scenarios with ``needs_control=True`` also get the same policy's scores on
the unmodified game, so that checks can assert a relative degradation.
"""

from __future__ import annotations

import time

import torch


def capture_setup(scenario, device="cuda"):
    """Run the scenario's intervention on one facade handle and capture the
    (config_json, state_json) it produces."""
    from toybox_tpu_torch import Toybox

    with Toybox(scenario.game, seed=scenario.seed, device=device) as tb:
        scenario.intervene(tb)
        return tb.config_to_json(), tb.to_state_json()


def play_batched(game: str, cfg_js, st_js, *, state_dict, alg: str,
                 network: str, n_episodes: int, seed: int = 0,
                 max_frames: int = 20_000, chunk: int = 128,
                 nlstm: int = 128, device="cuda"):
    """Play n_episodes in parallel from an injected (config, state) set-up
    (None for the game's default); returns the raw (uncapped, unclipped)
    episode scores, numpy f32. ``state_dict=None`` plays a randomly
    initialised policy (smoke); else it is loaded strictly into the eval
    head of ``alg``/``network``. Recurrent networks (an LSTM ``nlstm``
    wide) thread the LSTM carry, restarting it for the envs whose
    previous step ended an episode."""
    from toybox_tpu_torch.envs.pipeline import make_rl_env
    from toybox_tpu_torch.games import get_game
    from toybox_tpu_torch.regress import eval_policy

    module = get_game(game)
    cfg = (module.config_from_json(cfg_js, device) if cfg_js is not None
           else module.default_config(device))
    env = make_rl_env(game, n_episodes, config=cfg, episodic_life=False,
                      clip_rewards=False, device=device)
    net, step, carry = eval_policy(alg, network, env, seed, device, nlstm)
    if state_dict is not None:
        net.load_state_dict(state_dict)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    seeds = torch.arange(n_episodes, device=dev) + seed
    if st_js is not None:
        tree = module.state_from_json(cfg, st_js)
        st, _ = env.reset_to(tree, seeds, reseed=True)
    else:
        st, _ = env.reset(seeds)
    totals = torch.zeros(n_episodes, dtype=torch.float32, device=dev)
    finished = torch.zeros(n_episodes, dtype=torch.bool, device=dev)
    done = torch.zeros(n_episodes, dtype=torch.bool, device=dev)
    n_chunks = max(max_frames // env.frames_per_step // chunk, 1)
    for _ in range(n_chunks):
        for _ in range(chunk):
            actions, carry = step(st.frames, gen, carry, done)
            st, _, _, done, info = env.step(st, actions)
            totals = torch.where(finished, totals,
                                 totals + info["raw_reward"])
            finished = finished | done
        if bool(finished.all()):
            break
    return totals.cpu().numpy()


def env_config(module, cfg, device="cuda"):
    """``cfg``, or the game module's default config (on ``device``) when
    it is None."""
    return cfg if cfg is not None else module.default_config(device)


def run_scenario(scenario_cls, *, state_dict=None, alg: str = "ppo",
                 network: str = "cnn", episodes: int | None = None,
                 seed: int = 0, max_frames: int | None = None,
                 chunk: int = 128, control_cache: dict | None = None,
                 overrides: dict | None = None, device="cuda"):
    """Run one scenario (and its control, if its check needs one) and
    return {scores, control, passed, seconds}. ``control_cache`` (keyed on
    the control run's configuration) shares the unmodified game's rollout
    between scenarios of the same budget; ``seconds`` is the wall time of
    this call, a control it ran included.

    ``overrides`` recalibrates the check for a model family: attribute
    values set on the scenario instance (e.g. min_control,
    min_control_frac), or {"waived": "<rationale>"} to run the scenario
    but record passed=None."""
    t0 = time.perf_counter()
    s = scenario_cls(seed=seed)
    waived = None
    for k, v in (overrides or {}).items():
        if k == "waived":
            waived = v
        else:
            setattr(s, k, v)
    if episodes:
        s.n_episodes = episodes
    if max_frames:
        s.max_frames = min(s.max_frames, int(max_frames))

    cfg_js, st_js = capture_setup(s, device)
    kw = dict(state_dict=state_dict, alg=alg, network=network,
              n_episodes=s.n_episodes, seed=seed, max_frames=s.max_frames,
              chunk=min(chunk, max(s.max_frames // 4, 1)), device=device)
    scores = play_batched(s.game, cfg_js, st_js, **kw)
    control = None
    if getattr(s, "needs_control", False):
        ckey = (s.game, alg, network, s.n_episodes, seed, s.max_frames,
                kw["chunk"])
        if control_cache is not None and ckey in control_cache:
            control = control_cache[ckey]
        else:
            control = play_batched(s.game, None, None, **kw)
            if control_cache is not None:
                control_cache[ckey] = control
    out = {
        "scores": scores.tolist(),
        "control": None if control is None else control.tolist(),
        "passed": (None if waived is not None
                   else bool(s.check(scores, control))),
    }
    if waived is not None:
        out["waived"] = waived
    out["seconds"] = time.perf_counter() - t0
    return out


def run_all_gated(game: str, *, state_dict=None, alg: str = "ppo",
                  network: str = "cnn", episodes: int | None = None,
                  seed: int = 0, max_frames: int | None = None,
                  overrides: dict | None = None, device="cuda",
                  on_result=None):
    """Run every scenario of a game through the batched gate; control
    rollouts are shared between scenarios of the same budget.
    ``overrides`` maps a scenario class name to run_scenario overrides;
    ``on_result(name, result)`` is called after each scenario."""
    from toybox_tpu_torch.sample_tests import get_scenarios

    results = {}
    control_cache = {}
    for scenario_cls in get_scenarios(game):
        name = scenario_cls.__name__
        results[name] = run_scenario(
            scenario_cls, state_dict=state_dict, alg=alg, network=network,
            episodes=episodes, seed=seed, max_frames=max_frames,
            control_cache=control_cache,
            overrides=(overrides or {}).get(name), device=device)
        if on_result is not None:
            on_result(name, results[name])
    return results

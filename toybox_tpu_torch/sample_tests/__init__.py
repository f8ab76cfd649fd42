"""Behavioral acceptance tests (reference toybox.sample_tests, invoked by
scripts/utils/behavior_tests.sh — EnemyRemoval/OneEnemyTarget/GangUpNoJump,
EZChannel/LastBrick/PolarStarts, NoShields/JitterVary/ShieldXs), on the
port (a copy of toybox_tpu.sample_tests; the registry and the checks are
the JAX package's).

Run all scenarios for a game (the gate with a family's model on the card):

    python -m toybox_tpu_torch.sample_tests breakout --family=ppo
"""

from __future__ import annotations


def get_scenarios(game: str):
    if game in ("breakout",):
        from toybox_tpu_torch.sample_tests.test_breakout import SCENARIOS
    elif game in ("amidar",):
        from toybox_tpu_torch.sample_tests.test_amidar import SCENARIOS
    elif game in ("space_invaders", "spaceinvaders"):
        from toybox_tpu_torch.sample_tests.test_spaceinvaders import SCENARIOS
    else:
        raise ValueError(f"no scenarios for game {game!r}")
    return SCENARIOS


def run_all(game: str, policy=None, episodes=None, seed=0,
            max_frames=None, device="cuda"):
    """Per-frame (single-env) smoke run of every scenario through the
    facade on ``device``. Scenarios whose check needs a control run report
    ``passed=None`` here — the full gate (checks + controls, batched) is
    ``sample_tests.runner.run_all_gated``."""
    results = {}
    for scenario_cls in get_scenarios(game):
        s = scenario_cls(seed=seed)
        if episodes:
            s.n_episodes = episodes
        if max_frames:
            s.max_frames = min(s.max_frames, int(max_frames))
        scores = s.run(policy=policy, device=device)
        results[scenario_cls.__name__] = {
            "scores": scores.tolist(),
            "control": None,
            "passed": (None if s.needs_control else bool(s.check(scores))),
        }
    return results

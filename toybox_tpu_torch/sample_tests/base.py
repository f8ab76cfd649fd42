"""Behavioral acceptance-test harness.

The reference's research contribution (README.md:13-22): train an RL
agent, then verify it still behaves sensibly under white-box
interventions — no enemies, one targeting enemy, no shields, varied
jitter, a pre-built channel, only the last brick, shifted starts
(scripts/utils/behavior_tests.sh:4-17; the frozen test modules live in
toybox-rs/openai-baselines-envs).

``BehavioralFixture`` runs an agent (policy params or random) on a
Toybox instance whose state/config is modified by ``intervene`` before
(and optionally during) play, and scores the episodes. Concrete scenarios
subclass it per game.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class BehavioralFixture(ABC):
    """One intervention scenario: setup -> play N episodes -> assert."""

    game: str = None
    n_episodes: int = 5
    max_frames: int = 20_000
    #: run the same policy on the UNMODIFIED game too and pass those
    #: scores to ``check(scores, control)`` (relative-degradation gates)
    needs_control: bool = False
    timeout = property(lambda self: self.max_frames)

    def __init__(self, seed=0):
        self.seed = seed

    # -- scenario hooks ----------------------------------------------------
    @abstractmethod
    def intervene(self, tb) -> None:
        """Apply the white-box setup (runs after each new_game)."""

    def on_step(self, tb, frame: int) -> None:
        """Optional per-frame intervention hook."""

    def should_end(self, tb, frame: int) -> bool:
        return tb.game_over()

    # -- execution ---------------------------------------------------------
    def make_policy(self):
        """Default agent: uniform-random over the legal set. Trained
        agents are passed as ``run(policy=action_fn)`` where
        action_fn(tb) -> ale action (policy networks play the batched
        gate, sample_tests.runner)."""
        rng = np.random.default_rng(self.seed)

        def random_policy(tb):
            legal = tb.get_legal_action_set()
            return int(rng.choice(legal))
        return random_policy

    def run(self, policy=None, device="cuda"):
        """Play n_episodes with interventions applied, one frame at a time
        through the facade on ``device``; returns scores."""
        from toybox_tpu_torch import Toybox

        scores = []
        for ep in range(self.n_episodes):
            tb = Toybox(self.game, seed=self.seed + ep, device=device)
            self.intervene(tb)
            action_fn = policy or self.make_policy()
            for frame in range(self.max_frames):
                action_fn_out = action_fn(tb)
                tb.apply_ale_action(action_fn_out)
                self.on_step(tb, frame)
                if self.should_end(tb, frame):
                    break
            scores.append(tb.get_score())
        return np.asarray(scores)

    def check(self, scores, control=None) -> bool:
        """Default acceptance: agent still scores on average. Scenarios
        override this with a failable claim about the TRAINED agent
        (relative to ``control`` where needs_control is set)."""
        return float(np.mean(scores)) > 0

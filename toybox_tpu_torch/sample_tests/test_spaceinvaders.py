"""Space Invaders behavioral scenarios (reference behavior_tests.sh:14-17:
NoShields, JitterVary, ShieldXs).

A copy of the JAX package's scenarios; the "measured" figures in the
comments are that package's record (families.py), not the port's.
"""

from __future__ import annotations

import numpy as np

from toybox_tpu_torch.interventions.space_invaders import \
    SpaceInvadersIntervention
from toybox_tpu_torch.sample_tests.base import BehavioralFixture


class _RelativeCheck(BehavioralFixture):
    needs_control = True
    min_control_frac = 0.5
    #: absolute competence floor for the CONTROL run (measured ppo1
    #: control mean is ~5200-5400; guards the vacuous 0 >= frac*0 pass
    #: of a collapsed model)
    min_control = 500.0

    def check(self, scores, control=None):
        return (float(np.mean(control)) >= self.min_control
                and float(np.mean(scores))
                >= self.min_control_frac * float(np.mean(control)))


class NoShields(_RelativeCheck):
    """All shield pixels cleared: the agent must dodge without cover
    while its shooting lanes are clear."""

    game = "space_invaders"
    max_frames = 8_000
    # measured (SpaceInvaders.ppo1.model, chip, 2026-08-20): 1432 vs
    # control 5388 -> ratio 0.27 (the agent leans on its cover); gate at
    # 0.12 (~2x margin)
    min_control_frac = 0.12

    def intervene(self, tb):
        with SpaceInvadersIntervention(tb) as iv:
            for shield in iv.game.shields:
                for row in shield.data:
                    for px in row:
                        px.a = 0


class JitterVary(_RelativeCheck):
    """Enemy-fire randomness (the jitter config knob) swept to fully
    random, away from the training value (reference
    space_invaders.py:165-170)."""

    game = "space_invaders"
    max_frames = 8_000
    # measured (SpaceInvaders.ppo1.model, chip, 2026-08-20): 6516 vs
    # control 5388 -> ratio 1.21 (robust to fire randomness); gate at 0.5
    jitter = 1.0

    def intervene(self, tb):
        with SpaceInvadersIntervention(tb) as iv:
            iv.set_jitter(self.jitter)


class ShieldXs(_RelativeCheck):
    """Shields moved to shifted x positions: cover exists but not where
    the agent learned it."""

    game = "space_invaders"
    max_frames = 8_000
    # measured (SpaceInvaders.ppo1.model, chip, 2026-08-20): 632 vs
    # control 5388 -> ratio 0.117 (misplaced cover is WORSE than none);
    # gate at 0.05 (~2x margin)
    min_control_frac = 0.05
    xs = [60, 124, 188]

    def intervene(self, tb):
        cfg = tb.config_to_json()
        cfg["shields"] = [[x, 157] for x in self.xs]
        tb.write_config_json(cfg)
        tb.new_game()


SCENARIOS = [NoShields, JitterVary, ShieldXs]

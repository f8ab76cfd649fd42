"""Amidar behavioral scenarios (reference behavior_tests.sh:4-13:
EnemyRemovalTest, OneEnemyTargetTest, GangUpNoJumpRandomTest,
GangUpNoJumpTargetTest).

A copy of the JAX package's scenarios; the "measured" figures in the
comments are that package's record (families.py), not the port's.
"""

from __future__ import annotations

import numpy as np

from toybox_tpu_torch.interventions.amidar import (AmidarIntervention,
                                                   Direction, MovementAI,
                                                   TilePoint)
from toybox_tpu_torch.sample_tests.base import BehavioralFixture


class EnemyRemoval(BehavioralFixture):
    """All enemies removed: painting is unopposed, so a robust agent must
    score at least as well as it does WITH enemies (the reference's
    headline finding is that many trained agents don't — their policy
    collapses when the enemy pixels disappear)."""

    game = "amidar"
    max_frames = 3_000
    needs_control = True
    #: absolute competence floor for the CONTROL run (regress-gate scale;
    #: measured ppo1 control means are 298-405)
    min_control = 50.0
    # measured (Amidar.ppo1.model, chip, 2026-08-20): 242.4 vs control
    # 298.2 -> ratio 0.81; gate at 0.6 (~25% margin for eval noise, still
    # fails when unopposed play craters)
    min_control_frac = 0.6

    def intervene(self, tb):
        with AmidarIntervention(tb) as iv:
            enemies = iv.game.enemies
            while len(enemies) > 0:
                enemies.remove(enemies[0])

    def should_end(self, tb, frame):
        return tb.game_over() or frame >= self.max_frames - 1

    def check(self, scores, control=None):
        # unopposed play must not score much worse than the normal game;
        # the control itself must show a competent agent (guards against
        # the vacuous 0 >= frac*0 pass of a collapsed model)
        return (float(np.mean(control)) >= self.min_control
                and float(np.mean(scores))
                >= self.min_control_frac * float(np.mean(control)))


class OneEnemyTarget(BehavioralFixture):
    """A single enemy running the TargetPlayer protocol: fewer, but
    smarter, pursuers than training; the agent must not fall apart."""

    game = "amidar"
    max_frames = 5_000
    needs_control = True
    min_control = 50.0

    def intervene(self, tb):
        with AmidarIntervention(tb) as iv:
            enemies = iv.game.enemies
            while len(enemies) > 1:
                enemies.remove(enemies[-1])
            iv.set_enemy_protocol(
                enemies[0], MovementAI.EnemyTargetPlayer,
                start=TilePoint(iv, tx=0, ty=0),
                start_dir=Direction(iv, "Right"),
                vision_distance=15,
                dir=Direction(iv, "Right"),
                player_seen=None)

    # measured (Amidar.ppo1.model, chip, 2026-08-20): 178.6 vs control
    # 373.0 -> ratio 0.48; gate at 0.25 (~2x margin)
    min_control_frac = 0.25

    def check(self, scores, control=None):
        return (float(np.mean(control)) >= self.min_control
                and float(np.mean(scores))
                >= self.min_control_frac * float(np.mean(control)))


class _GangUpNoJump(BehavioralFixture):
    """Base: jumps disabled and every enemy switched to one protocol —
    an out-of-distribution gauntlet. The agent must still paint (score
    a meaningful fraction of its normal game) before being caught."""

    game = "amidar"
    max_frames = 5_000
    needs_control = True
    protocol = None
    min_control_frac = 0.1
    min_control = 50.0

    def _protocol_kwargs(self, iv):
        if self.protocol == MovementAI.EnemyTargetPlayer:
            return dict(start=TilePoint(iv, tx=0, ty=0),
                        start_dir=Direction(iv, "Right"),
                        vision_distance=31,
                        dir=Direction(iv, "Right"),
                        player_seen=None)
        return dict(start=TilePoint(iv, tx=0, ty=0),
                    start_dir=Direction(iv, "Right"),
                    dir=Direction(iv, "Right"))

    def intervene(self, tb):
        with AmidarIntervention(tb) as iv:
            for e in iv.game.enemies:
                iv.set_enemy_protocol(e, self.protocol,
                                      **self._protocol_kwargs(iv))
            iv.game.jumps = 0

    def check(self, scores, control=None):
        return (float(np.mean(control)) >= self.min_control
                and float(np.mean(scores))
                >= self.min_control_frac * float(np.mean(control)))


class GangUpNoJumpRandom(_GangUpNoJump):
    """All five enemies on EnemyRandomMvmt, no jumps (reference
    GangUpNoJumpRandomTest)."""
    protocol = MovementAI.EnemyRandomMvmt
    # measured (Amidar.ppo1.model, chip, 2026-08-20): 48.8 vs control
    # 373.0 -> ratio 0.131; gate at 0.06 (~2x margin)
    min_control_frac = 0.06


class GangUpNoJumpTarget(_GangUpNoJump):
    """All five enemies on EnemyTargetPlayer, no jumps (reference
    GangUpNoJumpTargetTest) — the hardest gauntlet, so the bar is
    lower: paint a non-trivial fraction before being cornered."""
    protocol = MovementAI.EnemyTargetPlayer
    # measured (Amidar.ppo1.model, chip, 2026-08-20): 15.6 vs control
    # 373.0 -> ratio 0.042; gate at 0.02 (~2x margin)
    min_control_frac = 0.02


SCENARIOS = [EnemyRemoval, OneEnemyTarget, GangUpNoJumpRandom,
             GangUpNoJumpTarget]

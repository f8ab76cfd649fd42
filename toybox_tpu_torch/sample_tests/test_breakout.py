"""Breakout behavioral scenarios (reference behavior_tests.sh:4-9:
EZChannel, LastBrick, PolarStarts).

A copy of the JAX package's scenarios; the "measured" figures in the
comments are that package's record (families.py), not the port's.
"""

from __future__ import annotations

import numpy as np

from toybox_tpu_torch.interventions.breakout import BreakoutIntervention
from toybox_tpu_torch.sample_tests.base import BehavioralFixture


class EZChannel(BehavioralFixture):
    """A channel is pre-cut. The board holds fewer points, but a robust
    agent still plays — it must keep a solid fraction of its normal
    score rather than stalling on the unfamiliar board."""

    game = "breakout"
    channel_col = 3
    needs_control = True
    # measured (Breakout.ppo1.model, chip, 2026-08-20): 1078 vs control
    # 1618 -> ratio 0.67; gate at 0.25

    def intervene(self, tb):
        with BreakoutIntervention(tb) as iv:
            iv.add_channel(self.channel_col)

    min_control = 100.0  # measured ppo1 control mean ~1300-1600
    min_control_frac = 0.25

    def check(self, scores, control=None):
        return (float(np.mean(control)) >= self.min_control
                and float(np.mean(scores))
                >= self.min_control_frac * float(np.mean(control)))


class LastBrick(BehavioralFixture):
    """Only one brick remains; the agent must clear it (generalization to
    a near-terminal state it rarely visits during training)."""

    game = "breakout"
    max_frames = 30_000

    def intervene(self, tb):
        with BreakoutIntervention(tb) as iv:
            for i, brick in enumerate(iv.game.bricks):
                brick.alive = (i == 50)

    def should_end(self, tb, frame):
        return (tb.game_over()
                or tb.rstate.breakout_bricks_remaining() == 0)

    #: fraction of episodes that must clear the lone brick (families.py
    #: recalibrates per family; measured ppo1 4/5, acktr 5/5, bc 2/5)
    min_clear_frac = 0.5

    def check(self, scores, control=None):
        # the lone brick is worth points, so score > 0 == cleared it
        return (float(np.mean(np.asarray(scores) > 0))
                >= self.min_clear_frac)


class PolarStarts(BehavioralFixture):
    """Ball always serves from the far-left start position instead of a
    random one of four — the agent must handle the skewed serve."""

    game = "breakout"
    needs_control = True
    # measured (Breakout.ppo1.model, chip, 2026-08-20): 1316 vs control
    # 1618 -> ratio 0.81; gate at 0.25

    min_control = 100.0
    min_control_frac = 0.25

    def intervene(self, tb):
        cfg = tb.config_to_json()
        cfg["ball_start_positions"] = [
            {"x": 24.0, "y": 80.0, "angle_degrees": 30.0}]
        tb.write_config_json(cfg)
        tb.new_game()

    def check(self, scores, control=None):
        return (float(np.mean(control)) >= self.min_control
                and float(np.mean(scores))
                >= self.min_control_frac * float(np.mean(control)))


SCENARIOS = [EZChannel, LastBrick, PolarStarts]

"""Model-family registry for the behavioral acceptance workflow.

The reference's research program runs its white-box scenarios across the
ALGORITHM FAMILIES it trains (reference scripts/utils/behavior_tests.sh
gates saved models; the papers' subject is how different training
regimes respond to interventions). This maps each committed gate-model
family to the eval head that loads it, and carries the per-family check
recalibrations, measured from the full 9-family x 10-scenario matrix
(scripts/behavior_matrix.py on the chip, 2026-08-20 — raw data in
docs/behavior_matrix.json, findings in docs/BEHAVIOR.md).

Calibration principle (same as the round-4 ppo1 calibration): relative
ratio gates sit ~2x below the family's MEASURED scenario/control ratio,
and absolute control floors sit ~2x below the family's measured control
mean — so the gate trips on real regressions (a broken intervention
path, a decayed model) without re-litigating each family's documented
behavioral profile. A cell override of {"waived": "<rationale>"} still
RUNS the scenario and records scores, but does not gate on it — used
only where the measured capability is zero (e.g. 0/5 LastBrick clears).

A copy of toybox_tpu.sample_tests.families: the registry and OVERRIDES are
the JAX package's, and every "measured" figure in the comments below (and
in the scenario modules) is that package's record on its own hardware, not
a measurement of this port.
"""

from __future__ import annotations

import os

#: family -> eval configuration. ``suffix`` names models/<Game>.<suffix>.model
FAMILIES = {
    "ppo": dict(alg="ppo", network="cnn", suffix="regress"),
    "ppo1": dict(alg="ppo1", network="cnn", suffix="ppo1"),
    "a2c": dict(alg="a2c", network="cnn", suffix="a2c"),
    "acer": dict(alg="acer", network="cnn_small", suffix="acer"),
    "acktr": dict(alg="acktr", network="cnn", suffix="acktr"),
    "trpo": dict(alg="trpo", network="cnn_small", suffix="trpo"),
    "deepq": dict(alg="deepq", network="conv_only", suffix="deepq"),
    "gail": dict(alg="gail", network="cnn", suffix="gail"),
    "bc": dict(alg="gail", network="cnn", suffix="bc"),
}

GAME_PREFIX = {"breakout": "Breakout", "amidar": "Amidar",
               "space_invaders": "SpaceInvaders"}


def model_path(family: str, game: str, models_dir: str = "models") -> str:
    return os.path.join(
        models_dir, f"{GAME_PREFIX[game]}.{FAMILIES[family]['suffix']}.model")


# Shared recalibrations -----------------------------------------------------

# Breakout EZChannel/PolarStarts floors: the in-class min_control=100 is
# ppo1-scale (ctrl 1618); measured controls are ppo 111 / a2c 768 /
# acer 241 / acktr 147 / trpo 59 / deepq 315 / gail 242 / bc 204.
_BK_FLOOR_50 = {"EZChannel": {"min_control": 50.0},
                "PolarStarts": {"min_control": 50.0}}
_BK_FLOOR_25 = {"EZChannel": {"min_control": 25.0},
                "PolarStarts": {"min_control": 25.0}}

#: measured 9x10 matrix calibrations (chip, 2026-08-20)
OVERRIDES: dict = {
    # --- ppo (ppo2 regress models) ---
    ("ppo", "breakout"): dict(_BK_FLOOR_50),
    ("ppo", "amidar"): {
        # measured EnemyRemoval ratio 71.4/139.4 = 0.51 — ppo2 leans on
        # enemy pixels (the reference's headline finding); gate at 0.25
        "EnemyRemoval": {"min_control_frac": 0.25},
    },
    ("ppo", "space_invaders"): {
        # ppo2's SI control is 448 raw (regress gate 469 capped); the
        # in-class floor 500 was ppo1-scale (ctrl 5388)
        "NoShields": {"min_control": 200.0},
        "JitterVary": {"min_control": 200.0},
        "ShieldXs": {"min_control": 200.0},
    },
    # --- a2c ---
    ("a2c", "breakout"): dict(_BK_FLOOR_50),
    # --- acer ---
    ("acer", "breakout"): {
        **_BK_FLOOR_50,
        "LastBrick": {"waived": "measured 0/5 lone-brick clears (ACER "
                                "Breakout, matrix 2026-08-20) — a "
                                "documented capability gap, not noise"},
    },
    ("acer", "amidar"): {
        # measured EnemyRemoval ratio 69.8/157.2 = 0.44; gate at 0.2
        "EnemyRemoval": {"min_control_frac": 0.2},
    },
    # --- acktr ---
    ("acktr", "breakout"): dict(_BK_FLOOR_50),   # LastBrick: 5/5 clears
    ("acktr", "amidar"): {
        # measured EnemyRemoval ratio 43.0/121.2 = 0.35; gate at 0.15
        "EnemyRemoval": {"min_control_frac": 0.15},
    },
    ("acktr", "space_invaders"): {
        # ACKTR's SI control is 444 raw (gate 415 capped); floor 200
        "NoShields": {"min_control": 200.0},
        "JitterVary": {"min_control": 200.0},
        "ShieldXs": {"min_control": 200.0},
    },
    # --- trpo ---
    ("trpo", "breakout"): {
        **_BK_FLOOR_25,   # trpo breakout control is 59.4 raw (gate 69)
        "LastBrick": {"waived": "measured 0/5 lone-brick clears (TRPO "
                                "Breakout gate 69; reference trpo_mpi "
                                "scored 18.0 on ALE Breakout)"},
    },
    ("trpo", "amidar"): {
        # measured EnemyRemoval ratio 44.0/133.2 = 0.33; gate at 0.15
        "EnemyRemoval": {"min_control_frac": 0.15},
    },
    # --- deepq ---
    ("deepq", "breakout"): dict(_BK_FLOOR_50),
    ("deepq", "amidar"): {
        # measured EnemyRemoval ratio 0.72 on chip but 0.57 on
        # forced-CPU (backend conv noise) — the 0.6 default has no
        # cross-backend margin; gate at 0.35
        "EnemyRemoval": {"min_control_frac": 0.35},
    },
    # --- gail / bc (imitation of the ppo1 experts) ---
    # Margin audit vs the chip matrix: every cell whose measured ratio
    # sits <1.5x above its gate gets widened to ~2x below measured, so
    # forced-CPU runs (conv noise moves both scores and controls) hold.
    ("gail", "breakout"): {
        **_BK_FLOOR_50,
        "EZChannel": {"min_control": 50.0, "min_control_frac": 0.15},
        "LastBrick": {"waived": "measured 0/5 lone-brick clears — the "
                                "adversarially-finetuned clone does not "
                                "generalize to the near-terminal state"},
    },
    ("gail", "amidar"): {
        "OneEnemyTarget": {"min_control_frac": 0.15},  # measured 0.33
    },
    ("gail", "space_invaders"): {
        "NoShields": {"min_control_frac": 0.06},       # measured 0.148
    },
    ("bc", "space_invaders"): {
        "NoShields": {"min_control_frac": 0.06},       # measured 0.149
    },
    ("bc", "breakout"): {
        **_BK_FLOOR_50,
        # measured 2/5 clears; gate at 1/5
        "LastBrick": {"min_clear_frac": 0.2},
        # measured EZChannel ratio 0.30 on chip but 0.23 on forced-CPU
        # (conv noise moves the control); gate at 0.15 so both backends
        # carry ~1.5-2x margin
        "EZChannel": {"min_control": 50.0, "min_control_frac": 0.15},
    },
}


def overrides_for(family: str, game: str) -> dict:
    return OVERRIDES.get((family, game), {})

"""ALE 18-action set and action -> Input decoding (port of
toybox_tpu.core.actions: ``ale_to_input`` and the legal action table)."""

from __future__ import annotations

import numpy as np
import torch

from toybox_tpu_torch.core.types import Input

ACTION_MEANING = {
    0: "NOOP",
    1: "FIRE",
    2: "UP",
    3: "RIGHT",
    4: "LEFT",
    5: "DOWN",
    6: "UPRIGHT",
    7: "UPLEFT",
    8: "DOWNRIGHT",
    9: "DOWNLEFT",
    10: "UPFIRE",
    11: "RIGHTFIRE",
    12: "LEFTFIRE",
    13: "DOWNFIRE",
    14: "UPRIGHTFIRE",
    15: "UPLEFTFIRE",
    16: "DOWNRIGHTFIRE",
    17: "DOWNLEFTFIRE",
}


def _build_table() -> np.ndarray:
    # columns: left, right, up, down, button1, button2
    tbl = np.zeros((18, 6), dtype=bool)
    for idx, name in ACTION_MEANING.items():
        tbl[idx, 0] = "LEFT" in name
        tbl[idx, 1] = "RIGHT" in name
        tbl[idx, 2] = "UP" in name
        tbl[idx, 3] = "DOWN" in name
        tbl[idx, 4] = "FIRE" in name
    return tbl


ACTION_TABLE = _build_table()

# Per-game legal ALE action subsets (ALE minimal sets).
LEGAL_ACTIONS = {
    "breakout": [0, 1, 3, 4],
    "amidar": [0, 1, 2, 3, 4, 5, 10, 11, 12, 13],
    "space_invaders": [0, 1, 3, 4, 11, 12],
    "gridworld": [0, 2, 3, 4, 5],
}


def ale_to_input(action: torch.Tensor) -> Input:
    """Decode ALE action indices (int tensor [...]) to a batched Input."""
    table = torch.as_tensor(ACTION_TABLE, device=action.device)
    row = table[action.long()]
    return Input(left=row[..., 0], right=row[..., 1], up=row[..., 2],
                 down=row[..., 3], button1=row[..., 4],
                 button2=torch.zeros_like(row[..., 4]))

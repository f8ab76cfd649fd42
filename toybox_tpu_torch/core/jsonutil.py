"""Host-side helpers for the reference JSON state schema (port of the part
of toybox_tpu.core.jsonutil that ``state_to_json`` needs)."""

from __future__ import annotations

import numpy as np

__all__ = ["color_to_json", "color_from_json"]


def color_to_json(c) -> dict:
    c = np.asarray(c).astype(np.int64)
    return {"r": int(c[0]), "g": int(c[1]), "b": int(c[2]), "a": int(c[3])}


def color_from_json(d) -> np.ndarray:
    return np.array([d["r"], d["g"], d["b"], d["a"]], dtype=np.uint8)

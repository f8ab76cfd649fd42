"""Host-side helpers for the reference JSON state and config schemas (port
of toybox_tpu.core.jsonutil): scalar leaves and small composite values
(Color, Vec2D) between device tensors and JSON, on the host."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["color_to_json", "color_from_json", "vec2d_to_json",
           "vec2d_from_json", "pyval"]


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def color_to_json(c) -> dict:
    c = np.asarray(c).astype(np.int64)
    return {"r": int(c[0]), "g": int(c[1]), "b": int(c[2]), "a": int(c[3])}


def color_from_json(d) -> np.ndarray:
    return np.array([d["r"], d["g"], d["b"], d["a"]], dtype=np.uint8)


def vec2d_to_json(v) -> dict:
    v = np.asarray(_host(v), dtype=np.float64)
    return {"x": float(v[0]), "y": float(v[1])}


def sanitize(obj):
    """Recursively convert numpy scalars to python scalars for json.dumps."""
    if isinstance(obj, dict):
        return {k: sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def vec2d_from_json(d) -> np.ndarray:
    return np.array([d["x"], d["y"]], dtype=np.float32)


def pyval(x):
    """A 0-d array, tensor or numpy scalar as its natural python scalar."""
    a = np.asarray(_host(x))
    if a.dtype == np.bool_:
        return bool(a)
    if np.issubdtype(a.dtype, np.integer):
        return int(a)
    if np.issubdtype(a.dtype, np.floating):
        return float(a)
    return a.tolist()

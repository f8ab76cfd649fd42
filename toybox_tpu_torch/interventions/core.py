"""Core value types + property-path API for interventions.

Mirrors reference toybox/interventions/core.py: ``Game`` (score/lives/
rand/level base), ``Direction``, ``Vec2D``, ``Color`` (clamped int
coersions), ``SpriteData``/``ColorCollectionCollection`` (2-D pixel
arrays), ``parse_property_access`` / ``get_property`` (the generic
mutation-point interface, core.py:271-304), and the generative-model
helpers ``distr``/``bool_support``/``inf_support`` (core.py:17-73 — the
KDE sampler here is a numpy Gaussian KDE, no sklearn dependency).

A copy of toybox_tpu.interventions.core (pure Python) over the port's
engines, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, List, Union

import numpy as np

from toybox_tpu_torch.interventions.base import (BaseMixin, Collection,
                                                 Intervention, MutationError)

__all__ = [
    "Game", "Direction", "Vec2D", "Color", "SpriteData",
    "ColorCollectionCollection", "parse_property_access", "get_property",
    "distr", "bool_support", "inf_support",
]


# ---------------------------------------------------------------------------
# Generative models of state (sampling support)
# ---------------------------------------------------------------------------

class _BoolSampler:
    def __init__(self, data):
        self.p = sum(1 for t in data if t) / max(len(data), 1)

    def sample(self, *a, **k):
        import random
        return random.random() < self.p


class _KdeSampler:
    """Gaussian KDE with Scott's-rule bandwidth, sampled as
    data[i] + N(0, bw) — numpy stand-in for the reference's sklearn
    KernelDensity pickle (core.py:49-73)."""

    def __init__(self, data):
        self.data = np.asarray(data, np.float64).reshape(-1)
        self.bw = max(len(self.data), 1) ** (-1.0 / 5)

    def sample(self, *a, **k):
        i = np.random.randint(len(self.data))
        return float(self.data[i] + np.random.normal(0.0, self.bw))


def bool_support(fname, data):
    return _BoolSampler(data)


def inf_support(fname, data):
    return _KdeSampler(data)


def distr(fname, data, kind=None):
    """Fit a per-field sampler from observed values."""
    if kind == "bool" or (len(data) and isinstance(data[0], bool)):
        return bool_support(fname, data)
    return inf_support(fname, data)


# ---------------------------------------------------------------------------
# Value types
# ---------------------------------------------------------------------------

class Game(BaseMixin):
    """Common game base: score/lives/rand/level (reference core.py:76-116).

    Abstract — subclasses do not reset _in_init here."""

    expected_keys = ["score", "lives", "rand", "level"]
    immutable_fields = BaseMixin.immutable_fields + ["rand", "reset"]
    coersions = {
        "score": lambda x: int(x),
        "lives": lambda x: int(x),
        "level": lambda x: int(x),
    }

    def __init__(self, intervention, score, lives, rand, level,
                 *args, **kwargs):
        super().__init__(intervention)
        self.score = score
        self.rand = rand
        self.lives = lives
        self.level = level


class Direction(BaseMixin):

    expected_keys: List[str] = []
    eq_keys = ["direction"]

    Up = "Up"
    Down = "Down"
    Left = "Left"
    Right = "Right"
    directions = [Up, Down, Left, Right]

    def __init__(self, intervention, direction):
        super().__init__(intervention)
        assert direction in Direction.directions, (
            "%s not found in directions" % direction)
        self.direction = direction
        self._in_init = False

    def decode(intervention, direction, clz):
        return Direction(intervention, direction)

    def encode(self):
        return self.direction

    def __str__(self):
        return self.direction


class Vec2D(BaseMixin):

    expected_keys = ["y", "x"]
    eq_keys = expected_keys
    coersions = {"x": float, "y": float}

    def __init__(self, intervention, x, y):
        super().__init__(intervention)
        self.x = float(x)
        self.y = float(y)
        self._in_init = False

    def __str__(self):
        return "({}, {})".format(self.x, self.y)


def _clamp255(x):
    return max(0, min(255, int(x)))


class Color(BaseMixin):

    expected_keys = ["r", "g", "b", "a"]
    eq_keys = expected_keys
    coersions = {"r": _clamp255, "g": _clamp255, "b": _clamp255,
                 "a": _clamp255}

    def __init__(self, intervention, r, g, b, a):
        super().__init__(intervention)
        self.r = r
        self.g = g
        self.b = b
        self.a = a
        self._in_init = False

    def __str__(self):
        return "({}, {}, {}, {})".format(self.r, self.g, self.b, self.a)


class ColorCollectionCollection(BaseMixin):
    """2-D pixel array of Colors (shield sprite data)."""

    expected_keys: List[str] = []
    eq_keys: List[str] = []
    immutable_fields = BaseMixin.immutable_fields + ["coll"]

    def __init__(self, intervention, rows):
        super().__init__(intervention)
        self.coll = [[Color.decode(intervention, px, Color) for px in row]
                     for row in rows]
        self._in_init = False

    def __getitem__(self, i):
        return self.coll[i]

    def __len__(self):
        return len(self.coll)

    def decode(intervention, coll, clz):
        return ColorCollectionCollection(intervention, coll)

    def encode(self):
        return [[c.encode() for c in row] for row in self.coll]


class SpriteData(BaseMixin):

    expected_keys = ["x", "y", "data"]
    eq_keys = expected_keys
    immutable_fields = BaseMixin.immutable_fields + ["data"]

    def __init__(self, intervention, x=None, y=None, data=None):
        super().__init__(intervention)
        self.x = x
        self.y = y
        self.data = ColorCollectionCollection.decode(intervention, data, None)
        self._in_init = False

    def __str__(self):
        return "Sprite at {}, {}".format(self.x, self.y)


# ---------------------------------------------------------------------------
# Property-path API (reference core.py:271-304)
# ---------------------------------------------------------------------------

_PROP_OR_NUM = re.compile(r"(\[\d+\])|(\.?\w+\.?)")


def parse_property_access(query: str) -> List[Union[str, int]]:
    """'abc.def[7].y' -> ['abc', 'def', 7, 'y']"""
    output = []
    for num_pat, word_pat in _PROP_OR_NUM.findall(query):
        if num_pat:
            output.append(int(num_pat[1:-1]))
        else:
            output.append(word_pat.replace(".", ""))
    return output


def get_property(s, prop: str, setval=None, get_container=False) -> Any:
    """Deep get/set on an intervention object via a property-path string.

    ``setval`` uses an ``is not None`` check in the reference
    (core.py:284-304) — but falsy values like 0 must still be settable
    (test_get_property.py:39-44), which works because only None is
    excluded."""
    levels = parse_property_access(prop)
    parent = None
    obj = s
    set_index = len(levels) - 1
    for level, p in enumerate(levels):
        if setval is not None and level == set_index:
            if isinstance(p, int):
                obj[p] = setval
            else:
                setattr(obj, p, setval)
        parent = obj
        obj = obj[p] if isinstance(p, int) else getattr(obj, p)
    return parent if get_container else obj

"""Intervention framework: typed, mutation-tracked mirrors of game state.

Same API surface as the reference's toybox/interventions/base.py (SURVEY.md
§2.3): ``MutationError``/``InterventionNoneError``, ``BaseMixin`` with the
``_in_init`` setattr guard and exact-key decode validation, list-like
``Collection``, ``StandardEq``/``SetEq`` equality modes, and the
``Intervention`` context manager whose __exit__ commits dirty config
(forcing a new game) or dirty state back to the engine
(reference base.py:387-408).

Here the "engine" is the port's Toybox facade (``toybox_tpu_torch.ctoybox``):
decode/encode run on the host against the JSON codec; the batched path
over [N, ...] states lives in toybox_tpu_torch.interventions.batched.

A copy of toybox_tpu.interventions.base (pure Python), kept in the port so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
from abc import ABC
from typing import Any, List, Union

__all__ = [
    "MutationError", "InterventionNoneError", "Eq", "StandardEq", "SetEq",
    "BaseMixin", "Collection", "Intervention", "get_schema_caching",
]


class MutationError(AttributeError):

    def __init__(self, attribute):
        super().__init__("Trying to mutate immutable field %s" % attribute)
        self.attribute = attribute


class InterventionNoneError(AttributeError):

    def __init__(self):
        super().__init__("intervention cannot be None")


# ---------------------------------------------------------------------------
# Equality modes (reference base.py:31-120)
# ---------------------------------------------------------------------------

class Eq(ABC):

    def __init__(self, obj):
        self.obj = obj
        self.clz = obj.__class__


class StandardEq(Eq):
    """Boolean equality over eq_keys."""

    def __eq__(self, other) -> bool:
        for key in self.clz.eq_keys:
            if getattr(self.obj, key) != getattr(other.obj, key):
                return False
        return True


class SetEq(Eq):
    """Structural diff: equality result is the list of (path, v1, v2)."""

    def __init__(self, obj):
        super().__init__(obj)
        self.differs = []

    @staticmethod
    def _coll_diff(this, that, collname="COLLECTION"):
        differs = []
        if len(this) != len(that):
            differs.append(("len({})".format(collname), len(this), len(that)))
            return differs
        for i, (a, b) in enumerate(zip(this, that)):
            for key, v1, v2 in (a == b).differs:
                differs.append(("{}[{}].{}".format(collname, i, key), v1, v2))
        return differs

    def __eq__(self, other) -> "SetEq":
        if isinstance(self.obj, Collection):
            self.differs.extend(SetEq._coll_diff(self.obj, other.obj))
            return self

        for key in self.clz.eq_keys:
            v1 = getattr(self.obj, key)
            v2 = getattr(other.obj, key)
            assert type(v1) == type(v2), "{} vs {} for {}".format(
                type(v1), type(v2), key)
            if isinstance(v1, Collection):
                self.differs.extend(SetEq._coll_diff(v1, v2, key))
            elif isinstance(v1, BaseMixin):
                for k, a, b in (v1 == v2).differs:
                    self.differs.append((key + "." + k, a, b))
            elif type(v1) is float:
                if not math.isclose(v1, v2):
                    self.differs.append((key, v1, v2))
            else:
                if v1 != v2:
                    self.differs.append((key, v1, v2))
        return self

    def __bool__(self):
        return len(self.differs) == 0

    def __len__(self):
        return len(self.differs)

    def __str__(self):
        return "SetEq{" + ";".join(
            "({}, {}, {})".format(*t) for t in self.differs) + "}"

    def difference(self, other: "SetEq"):
        """Triples in self not present in other."""
        return [t for t in self.differs if t not in other.differs]


_CACHED_SCHEMA = {}


def get_schema_caching(toybox):
    """Memoized schema_for_state per game (reference base.py:122-129)."""
    name = toybox.game_name
    if name not in _CACHED_SCHEMA:
        _CACHED_SCHEMA[name] = toybox.schema_for_state()
    return _CACHED_SCHEMA[name]


# ---------------------------------------------------------------------------
# BaseMixin / Collection
# ---------------------------------------------------------------------------

class BaseMixin(ABC):
    """Root of the intervention object model.

    Mutation guard semantics (reference base.py:154-186, validated by
    test_breakout_interventions.py:17-30):
    - fields may only be added during __init__ (tracked by the _in_init
      flag, not stack inspection — the reference's 7.386s -> 0.011s fix)
    - _in_init can never be set back to True once it exists
    - setting `intervention` post-init: None -> InterventionNoneError,
      otherwise MutationError (it is in immutable_fields)
    - any successful post-init set flips intervention.dirty_state
    """

    expected_keys: List[str] = []
    eq_keys: List[str] = []
    immutable_fields = ["intervention"]
    coersions = {}

    def __init__(self, intervention):
        self._in_init = True
        self.intervention = intervention
        self.schema = (get_schema_caching(intervention.toybox)
                       if intervention is not None and
                       getattr(intervention, "toybox", None) is not None
                       else {})

    def __setattr__(self, name, value):
        adding_new = name not in self.__dict__
        if name == "_in_init" and value is True and not adding_new:
            raise MutationError(name)
        if name in self.coersions:
            value = self.coersions[name](value)
        object.__setattr__(self, name, value)

        if self.__dict__.get("_in_init", True):
            return
        if self.intervention is None:
            raise InterventionNoneError()
        if name in self.immutable_fields:
            raise MutationError(name)
        if adding_new:
            raise MutationError(
                "Cannot add new field %s to %s" % (name,
                                                   type(self).__name__))
        if name != "_in_init":
            self.intervention.dirty_state = True

    @staticmethod
    def _validate_keys(obj, clz):
        actual = set(obj.keys())
        expected = set(clz.expected_keys)
        missing = expected - actual
        extra = actual - expected
        if missing:
            raise ValueError(
                "Missing keys (%s); maybe input is not a %s object?"
                % (missing, clz.__name__))
        if extra:
            raise ValueError(
                "Input object contains too many keys (%s); has the "
                "specification for %s changed?" % (actual, clz.__name__))

    def decode(intervention, obj, clz):
        BaseMixin._validate_keys(obj, clz)
        return clz(intervention, **obj)

    def encode(self):
        dat = {}
        for name, val in vars(self).items():
            if name not in self.expected_keys:
                continue
            dat[name] = val.encode() if isinstance(val, BaseMixin) else val
        return dat

    def __eq__(self, other) -> Union[bool, Eq]:
        return self.eq_mode(self) == other.eq_mode(other)

    @property
    def eq_mode(self):
        return self.intervention.eq_mode

    def sample(self, *queries):
        raise NotImplementedError(
            "sampling requires models; see "
            "toybox_tpu_torch.interventions.models")

    def make_models(self, data):
        raise NotImplementedError


class Collection(BaseMixin):
    """List-like BaseMixin: every mutator flips dirty_state
    (reference base.py:270-367)."""

    expected_keys: List[str] = []
    eq_keys: List[str] = []
    immutable_fields = BaseMixin.immutable_fields + ["coll"]

    def __init__(self, intervention, coll, elt_clz):
        super().__init__(intervention)
        self.elt_clz = elt_clz
        self.coll = [elt_clz.decode(intervention, elt, elt_clz)
                     for elt in coll]

    def __iter__(self):
        return iter(self.coll)

    def __getitem__(self, key):
        return self.coll[key]

    def __setitem__(self, key, value):
        self.coll[key] = value
        self.intervention.dirty_state = True

    def __len__(self):
        return len(self.coll)

    def __str__(self):
        return "[{}]".format(", ".join(str(c) for c in self.coll))

    def _mutate(self):
        self.intervention.dirty_state = True

    def append(self, obj):
        assert isinstance(obj, self.elt_clz), (
            "%s must be of type %s" % (obj, self.elt_clz))
        self.coll.append(obj)
        self._mutate()

    def extend(self, objs):
        self.coll.extend(objs)
        self._mutate()

    def insert(self, i, x):
        self.coll.insert(i, x)
        self._mutate()

    def remove(self, obj):
        self.coll.remove(obj)
        self._mutate()

    def pop(self, i=-1):
        self._mutate()
        return self.coll.pop(i)

    def clear(self):
        self.coll.clear()
        self._mutate()

    def index(self, x, *args):
        return self.coll.index(x, *args)

    def count(self, x):
        return self.coll.count(x)

    def sort(self, key=None, reverse=False):
        self._mutate()
        self.coll.sort(key=key, reverse=reverse)

    def reverse(self):
        self._mutate()
        self.coll.reverse()

    def copy(self):
        return Collection(self.intervention, self.coll.copy(), self.elt_clz)

    def encode(self):
        return [elt.encode() for elt in self.coll]

    def decode(intervention, coll, clz):
        return clz(intervention, coll)


# ---------------------------------------------------------------------------
# Intervention context manager
# ---------------------------------------------------------------------------

class Intervention(ABC):
    """__enter__ decodes config+state; __exit__ commits:
    dirty_config => write_config_json + new_game (config changes restart);
    elif dirty_state => write_state_json (reference base.py:387-408)."""

    def __init__(self, tb, game_name: str, clz: type, modelmod=None,
                 data=None, eq_mode=StandardEq):
        assert tb.game_name == game_name, (tb.game_name, game_name)
        self.game_name = game_name
        self.toybox = tb
        self.config = None
        self.dirty_config = False
        self.dirty_state = False
        self.clz = clz
        self.game = None
        self.modelmod = modelmod
        self.data = data
        self.eq_mode = eq_mode

    def __enter__(self):
        self.config = self.toybox.config_to_json()
        self.game = self.clz.decode(self, self.toybox.to_state_json(),
                                    self.clz)
        if self.modelmod:
            if self.data:
                self.make_models()
            self.load_models()
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        if self.dirty_config:
            self.toybox.write_config_json(self.config)
            self.toybox.new_game()
        elif self.dirty_state:
            self.toybox.write_state_json(self.game.encode())
        self.config = None

    def set_partial_config(self, fname):
        """Merge keys from a JSON file into the live config
        (reference base.py:411-420)."""
        if os.path.isfile(fname):
            with open(fname) as f:
                data = json.load(f)
            for k in data.keys():
                if k in self.config.keys():
                    self.config[k] = data[k]
                    self.dirty_config = True

    def load_models(self):
        import importlib
        return importlib.import_module(self.modelmod)

    def make_models(self):
        self.clz.make_models(self.modelmod, self.data)

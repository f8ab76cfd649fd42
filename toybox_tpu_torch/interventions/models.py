"""Generative models of game state (port of
toybox_tpu.interventions.models, pure numpy): the reference's
model-sampling subsystem (toybox/interventions/core.py:17-73
distr/bool_support/inf_support + the code-gen'd sampler modules from
resources/*_template.py).

Fit per-field samplers from observed state trajectories, then resample
chosen fields of a state to generate counterfactual start states:

    models = fit_models([tb.to_state_json() for tb in trajectory])
    new_state = sample_state(models, base_state, "paddle.position.x")
    tb.write_state_json(new_state)

Booleans fit Bernoulli; numbers fit a Gaussian KDE (Scott's-rule
bandwidth, numpy — the reference pickles sklearn KernelDensity objects).
``write_model_modules`` code-gens self-contained sampler .py files (the
reference's resources/ template mechanism) for offline use.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from toybox_tpu_torch.interventions.core import parse_property_access


class BoolModel:
    kind = "bool"

    def __init__(self, values):
        self.p = float(np.mean([bool(v) for v in values]))

    def sample(self, rng=np.random):
        return bool(rng.random() < self.p)


class KdeModel:
    kind = "number"

    def __init__(self, values):
        self.data = np.asarray(values, np.float64).reshape(-1)
        self.bw = max(len(self.data), 1) ** (-1.0 / 5) * (
            self.data.std() + 1e-8)
        self.is_int = all(float(v).is_integer() for v in self.data[:100])

    def sample(self, rng=np.random):
        i = rng.integers(len(self.data)) if hasattr(rng, "integers") \
            else rng.randint(len(self.data))
        v = float(self.data[i] + rng.normal(0.0, self.bw))
        return int(round(v)) if self.is_int else v


def _walk(obj, path=""):
    """Yield (path, scalar) for every bool/number leaf of a state dict.
    Collection elements get indexed paths ('bricks[7].alive') matching
    the reference's brick%04d module naming scheme."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk(v, f"{path}.{k}" if path else k)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]")
    elif isinstance(obj, bool):
        yield path, obj
    elif isinstance(obj, (int, float)):
        yield path, obj


def fit_models(states: List[dict], skip=("rand",)) -> Dict[str, Any]:
    """states: observed state JSON dicts -> {path: model}."""
    columns: Dict[str, list] = {}
    for s in states:
        for path, v in _walk(s):
            if any(path.startswith(sk) for sk in skip):
                continue
            columns.setdefault(path, []).append(v)
    models = {}
    for path, vals in columns.items():
        if all(isinstance(v, bool) for v in vals):
            models[path] = BoolModel(vals)
        else:
            models[path] = KdeModel(vals)
    return models


def _deep_set(obj, parts, value):
    node = obj
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def sample_state(models: Dict[str, Any], base_state: dict, *queries,
                 rng=None) -> dict:
    """Return a copy of base_state with the queried paths (all modeled
    paths if none given) resampled from the fitted models."""
    import copy

    rng = rng or np.random.default_rng()
    new = copy.deepcopy(base_state)
    paths = queries if queries else models.keys()
    for q in paths:
        if q not in models:
            raise KeyError(f"no model fitted for {q!r}; have e.g. "
                           f"{list(models)[:5]}")
        parts = parse_property_access(q)
        _deep_set(new, parts, models[q].sample(rng))
    return new


def write_model_modules(models: Dict[str, Any], outdir: str) -> None:
    """Code-gen self-contained sampler modules (one .py per field; the
    reference's resources/*_template.py mechanism without sklearn
    pickles)."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "__init__.py"), "w") as f:
        f.write("# generated sampler package (toybox_tpu_torch)\n")
    for path, m in models.items():
        fname = (path.replace(".", "_").replace("[", "")
                 .replace("]", "")) + ".py"
        with open(os.path.join(outdir, fname), "w") as f:
            if m.kind == "bool":
                f.write("from random import random\n\n"
                        f"P = {m.p!r}\n\n"
                        "def sample(*args, **kwargs):\n"
                        "    return random() < P\n")
            else:
                f.write("import random\n\n"
                        f"DATA = {m.data.tolist()!r}\n"
                        f"BW = {float(m.bw)!r}\n"
                        f"IS_INT = {bool(m.is_int)!r}\n\n"
                        "def sample(*args, **kwargs):\n"
                        "    v = random.choice(DATA) + "
                        "random.gauss(0.0, BW)\n"
                        "    return int(round(v)) if IS_INT else v\n")

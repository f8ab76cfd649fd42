"""The port's state samplers (interventions/models.py) against the JAX
package's: every case of tests/test_state_models.py on the port, and
fit_models, sample_state and write_model_modules equal to JAX's on the
same trajectory and generator."""

import importlib.util

import numpy as np
import pytest

import toybox_tpu
from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.interventions import models as jmodels
from toybox_tpu_torch import Toybox
from toybox_tpu_torch.interventions.models import (fit_models, sample_state,
                                                   write_model_modules)


def _play(tb):
    """The trajectory of tests/test_state_models.py: FIRE, then 12 x 5
    frames of alternating paddle moves, a state JSON after each 5."""
    tb.apply_ale_action(1)
    states = []
    for i in range(12):
        for _ in range(5):
            tb.apply_ale_action(3 if i % 2 else 4)
        states.append(tb.to_state_json())
    return states


@pytest.fixture(scope="module")
def trajectory():
    states = _play(Toybox("breakout", device="cpu"))
    assert states == _play(toybox_tpu.Toybox("breakout"))
    return states


# -- the cases of tests/test_state_models.py ---------------------------------

def test_fit_and_sample(trajectory):
    models = fit_models(trajectory)
    assert "paddle.position.x" in models
    assert "bricks[0].alive" in models
    assert models["bricks[0].alive"].kind == "bool"
    assert models["paddle.position.x"].kind == "number"
    base = trajectory[0]
    new = sample_state(models, base, "paddle.position.x",
                       rng=np.random.default_rng(0))
    assert new["lives"] == base["lives"]
    tb = Toybox("breakout", device="cpu")
    tb.write_state_json(new)          # sampled states load into the engine
    assert tb.get_lives() == base["lives"]


def test_sample_all_fields_valid(trajectory):
    models = fit_models(trajectory)
    new = sample_state(models, trajectory[-1], rng=np.random.default_rng(1))
    tb = Toybox("breakout", device="cpu")
    tb.write_state_json(new)          # a fully resampled state loads
    tb.apply_ale_action(0)            # and steps


def test_unknown_query_raises(trajectory):
    with pytest.raises(KeyError):
        sample_state(fit_models(trajectory), trajectory[0], "not.a.field")


def test_write_model_modules(tmp_path, trajectory):
    write_model_modules(fit_models(trajectory), str(tmp_path / "models"))
    f = tmp_path / "models" / "paddle_position_x.py"
    spec = importlib.util.spec_from_file_location("m", f)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    v = mod.sample()
    assert isinstance(v, (int, float)) and 0 <= v <= 250


# -- against the JAX package -------------------------------------------------

def test_fit_models_matches_jax(trajectory):
    mine, theirs = fit_models(trajectory), jmodels.fit_models(trajectory)
    assert list(mine) == list(theirs)
    for path, m in mine.items():
        j = theirs[path]
        assert m.kind == j.kind, path
        if m.kind == "bool":
            assert m.p == j.p, path
        else:
            np.testing.assert_array_equal(m.data, j.data, path)
            assert (m.bw, m.is_int) == (j.bw, j.is_int), path


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_state_matches_jax(trajectory, seed):
    mine, theirs = fit_models(trajectory), jmodels.fit_models(trajectory)
    for queries in ((), ("paddle.position.x", "bricks[7].alive",
                         "balls[0].velocity.y")):
        assert sample_state(mine, trajectory[3], *queries,
                            rng=np.random.default_rng(seed)) == \
            jmodels.sample_state(theirs, trajectory[3], *queries,
                                 rng=np.random.default_rng(seed))


def test_model_modules_match_jax_but_the_header(tmp_path, trajectory):
    write_model_modules(fit_models(trajectory), str(tmp_path / "port"))
    jmodels.write_model_modules(jmodels.fit_models(trajectory),
                                str(tmp_path / "jax"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        mine = (tmp_path / "port" / name).read_text().splitlines()
        theirs = (tmp_path / "jax" / name).read_text().splitlines()
        if name == "__init__.py":
            assert mine == ["# generated sampler package (toybox_tpu_torch)"]
        else:
            assert mine == theirs, name

"""The port's utility, measurement and bench modules
(toybox_tpu_torch.utils.{misc, schedules, profiler, mfu, benchmarks} and
toybox_tpu_torch.benchmark) against the JAX package's.

- tests/test_utils.py:10 and :19 (misc), tests/test_rl.py:181
  (schedules) and tests/test_utils.py:77 (``wall_timer``) in the port,
  and misc's functions equal to JAX's on the same inputs.
- ``ppo_update_flops`` equal to JAX's; ``program_flops`` of a Dense layer
  2 * in * out * batch; ``device_peak_flops`` None on the CPU.
- The named suites equal to JAX's.
- ``bench_raw_engine``, ``bench_gym_wrapped`` and ``bench_batched`` at
  tiny sizes on the CPU, and ``main``'s JSON keys equal to JAX's (the
  measurements stubbed in both).
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu import benchmark as jbench
from toybox_tpu.utils import benchmarks as jsuites, misc as jmisc
from toybox_tpu.utils import mfu as jmfu
from toybox_tpu_torch import benchmark
from toybox_tpu_torch.utils import benchmarks, logger, mfu, misc, profiler
from toybox_tpu_torch.utils.schedules import (ConstantSchedule,
                                              LinearSchedule,
                                              PiecewiseSchedule)


def test_explained_variance_and_discount():
    """tests/test_utils.py:10 in the port."""
    y = np.array([1.0, 2.0, 3.0])
    assert misc.explained_variance(y, y) == 1.0
    assert abs(misc.explained_variance(np.zeros(3), y)) < 1e9
    d = misc.discount(np.array([[1.0], [1.0], [1.0]]), 0.5)
    np.testing.assert_allclose(d[:, 0], [1.75, 1.5, 1.0])
    r = np.random.default_rng(0)
    a, b = r.normal(size=20), r.normal(size=20)
    assert misc.explained_variance(a, b) == jmisc.explained_variance(a, b)
    assert np.isnan(misc.explained_variance(a, np.ones(20)))
    x = r.normal(size=(6, 3))
    np.testing.assert_array_equal(misc.discount(x, 0.9),
                                  jmisc.discount(x, 0.9))
    misc.set_global_seeds(3)
    u = np.random.uniform()
    jmisc.set_global_seeds(3)
    assert np.random.uniform() == u


def test_tile_images():
    """tests/test_utils.py:19 in the port."""
    imgs = np.zeros((5, 4, 6, 3), np.uint8)
    assert misc.tile_images(imgs).shape == (8, 18, 3)
    imgs = np.random.default_rng(0).integers(0, 256, (7, 3, 2, 1), np.uint8)
    np.testing.assert_array_equal(misc.tile_images(imgs),
                                  jmisc.tile_images(imgs))


def test_schedules():
    """tests/test_rl.py:181 in the port."""
    s = LinearSchedule(100, final_p=0.1, initial_p=1.0)
    assert s.value(0) == 1.0
    assert abs(s.value(50) - 0.55) < 1e-9
    assert s.value(1000) == pytest.approx(0.1)
    p = PiecewiseSchedule([(0, 0.0), (10, 1.0)], outside_value=5.0)
    assert p.value(5) == pytest.approx(0.5)
    assert p.value(100) == 5.0
    assert ConstantSchedule(2.5)(7) == 2.5
    with pytest.raises(ValueError, match="increasing"):
        PiecewiseSchedule([(0, 0.0), (0, 1.0)])


def test_profiler_wall_timer_trace_and_annotate(tmp_path, capsys):
    """tests/test_utils.py:77 in the port, and the trace helpers."""
    lg = logger.configure(dir=str(tmp_path / "log"), format_strs=[])
    with profiler.wall_timer("thing", lg):
        pass
    assert "wait_thing" in lg.name2val
    with profiler.wall_timer("printed"):
        pass
    assert "printed:" in capsys.readouterr().out

    @profiler.annotate("double")
    def double(x):
        return x * 2

    with profiler.device_trace(str(tmp_path / "trace")):
        assert torch.equal(double(torch.ones(3)), torch.full((3,), 2.0))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "double" for e in trace["traceEvents"])


def test_flop_accounting():
    assert mfu.ppo_update_flops(1234.5, 2048, 4) == \
        jmfu.ppo_update_flops(1234.5, 2048, 4)
    layer = torch.nn.Linear(20, 30)
    x = torch.zeros(8, 20)
    assert mfu.program_flops(layer, x) == 2 * 20 * 30 * 8
    assert mfu.network_fwd_flops(layer, x) == 2 * 20 * 30

    def train(x):
        layer(x).sum().backward()

    # the forward, then the weight's gradient (x needs none)
    assert mfu.program_flops(train, x) == 2 * 2 * 20 * 30 * 8
    assert mfu.device_peak_flops("cpu") is None
    assert mfu.device_peak_flops(torch.device("cpu"), torch.float32) is None


def test_named_suites_match_jax():
    assert benchmarks.list_benchmarks() == jsuites.list_benchmarks()
    for name in jsuites.list_benchmarks():
        assert benchmarks.get_benchmark(name) == jsuites.get_benchmark(name)
    b = benchmarks.get_benchmark("Toybox10M")
    assert benchmarks.get_task(b, "AmidarToyboxNoFrameskip-v4")[
        "num_timesteps"] == int(1e7)
    with pytest.raises(ValueError, match="unknown benchmark"):
        benchmarks.get_benchmark("nope")
    with pytest.raises(ValueError, match="already registered"):
        benchmarks.register_benchmark({"name": "ToyboxQuick", "tasks": []})


def test_bench_functions_tiny():
    mean, sem = benchmark.bench_raw_engine("breakout", 4, 2, device="cpu")
    assert mean > 0 and sem >= 0
    mean, sem = benchmark.bench_batched("space_invaders", 4, 2, 2,
                                        device="cpu")
    assert mean > 0 and sem >= 0
    mean, sem = benchmark.bench_gym_wrapped("gridworld", 2, 1, device="cpu")
    assert mean > 0 and sem == 0.0
    assert benchmark._mean_sem([2.0]) == (2.0, 0.0)
    assert benchmark._mean_sem([1.0, 3.0]) == jbench._mean_sem([1.0, 3.0])


@pytest.mark.parametrize("extra", [["--skip-gym"], []])
def test_main_prints_jax_keys(monkeypatch, capsys, extra):
    def stub(*args, **kwargs):
        return 100.0, 1.0

    for mod in (benchmark, jbench):
        for fn in ("bench_raw_engine", "bench_gym_wrapped", "bench_batched"):
            monkeypatch.setattr(mod, fn, stub)
    argv = ["--game", "amidar", "--reps", "2", "--steps", "16",
            "--batch-sizes", "4,8"] + extra
    mine = benchmark.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == mine
    assert set(mine) == set(jbench.main(argv))
    assert mine["game"] == "amidar" and mine["batched_8_fps"] == {
        "mean": 100.0, "sem": 1.0}

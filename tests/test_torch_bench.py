"""The port's headline line (bench_torch.py), PPO step timer
(scripts/port_ppo_step_timing.py) and behavior matrix
(scripts/port_behavior_matrix.py) on the CPU at tiny sizes, against the
root bench.py and the JAX scripts they stand beside.

- The three rate functions give positive rates (tests/test_bench.py's
  tiny run, at one env for the PPO update: 128 samples a minibatch epoch
  set on one thread).
- ``main``'s JSON line has bench.py's keys, apart from
  ``train_mfu_f32_effective`` -> ``train_mfu_f32_peak`` and the added
  ``device``; with the same rates, the same values.
- FLOPs: the yardstick held is the analytic NatureCNN count (matmuls and
  convolutions, 2 per multiply-add: 2 x 9 345 536 a Breakout sample, the
  heads 512 x (4 + 1)), which FlopCounterMode gives exactly;
  ``ppo_update_flops`` of it equals JAX's. JAX's bench.py counts with
  XLA's cost analysis, which adds elementwise work and the sampling: on
  the build box's CPU it gives 18 792 108 a sample for the same act_fn,
  0.54 % above the analytic count (``python tests/test_torch_bench.py``
  prints it, ~30 s).
- Each function's units a rep equal bench.py's formula.
- The step timer runs each variant's update set-up, and one timed update;
  the matrix runs one family on one game for real, and with both
  packages' games replaced by the same fake scores its JSON equals the
  JAX script's (cells, keys, verdicts and means).
"""

import ast
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.utils import mfu as jmfu

import bench
import bench_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEV = torch.device("cpu")


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


step_timing = _load(ROOT / "scripts" / "port_ppo_step_timing.py",
                    "port_ppo_step_timing")
port_matrix = _load(ROOT / "scripts" / "port_behavior_matrix.py",
                    "port_behavior_matrix")


def nature_cnn_flops(n_actions: int) -> int:
    """2 x the multiply-adds of NatureCNN and its pi and value heads on
    an 84 x 84 x 4 observation."""
    macs, size, cin = 0, 84, 4
    for cout, k, stride in ((32, 8, 4), (64, 4, 2), (64, 3, 1)):
        size = (size - k) // stride + 1
        macs += size * size * cout * k * k * cin
        cin = cout
    macs += size * size * cin * 512 + 512 * (n_actions + 1)
    return 2 * macs


def test_rate_functions_tiny():
    """tests/test_bench.py's tiny run on the port."""
    assert bench_torch.bench_env_steps(n_envs=8, n_steps=4, reps=1,
                                       device="cpu") > 0
    assert bench_torch.bench_pipeline(n_envs=8, n_steps=2, reps=1,
                                      device="cpu") > 0
    train = bench_torch.bench_train("gridworld", n_envs=1, reps=1,
                                    device="cpu")
    assert train["train_frames_per_s"] > 0
    assert train["train_tflops_per_s"] > 0
    assert "train_mfu_bf16_peak" not in train    # no peak for the CPU


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        bench_torch.bench_env_steps(n_envs=8, n_steps=1, reps=1)
    with pytest.raises(RuntimeError, match="no GPU"):
        step_timing.main(["gridworld", "1"])


def _jax_train_keys() -> set:
    """The keys bench.py's bench_train writes (its ``out[...] =``)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_train")
    keys = {n.slice.value for n in ast.walk(fn)
            if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)}
    keys |= {k.value for n in ast.walk(fn) if isinstance(n, ast.Dict)
             for k in n.keys}
    return keys


def test_main_json_line_matches_bench(monkeypatch):
    rates = {"breakout": 9.0e5, "amidar": 8.0e5, "space_invaders": 1.1e6}
    for module in (bench, bench_torch):
        monkeypatch.setattr(module, "bench_env_steps",
                            lambda game, **kw: rates[game])
        monkeypatch.setattr(module, "bench_pipeline",
                            lambda game, **kw: rates[game] / 8)
    jax_keys = _jax_train_keys()
    assert jax_keys == {"train_frames_per_s", "train_tflops_per_s",
                        "train_mfu_bf16_peak", "train_mfu_f32_effective"}
    monkeypatch.setattr(bench, "bench_train", lambda **kw: {
        k: 1.0 for k in jax_keys})
    # the port's own rates on a card with published peaks
    monkeypatch.setattr(bench_torch, "device_peak_flops",
                        lambda dev, dtype: {torch.bfloat16: 989.5e12,
                                            torch.float32: 67e12}[dtype])
    monkeypatch.setattr(bench_torch, "bench_train", lambda **kw:
                        bench_torch.train_rates(5.0e5, 3.2e13, 7.8, DEV))

    printed = []
    monkeypatch.setattr("builtins.print", lambda s: printed.append(s))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    bench.main()
    monkeypatch.setattr(sys, "argv", ["bench_torch.py", "--device", "cpu"])
    bench_torch.main()
    assert len(printed) == 2
    want, got = map(json.loads, printed)
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    for key in ("metric", "value", "unit", "vs_baseline", "headline_game",
                "pipeline_frames_per_s", "compat_metric", "measures",
                "pipeline_envs"):
        assert got[key] == want[key], key
    assert got["headline_game"] == "amidar"
    assert set(got["games"]) == set(want["games"])
    for game, g in got["games"].items():
        w = want["games"][game]
        assert set(g) == set(w) - {"train_mfu_f32_effective"} | {
            "train_mfu_f32_peak"}
        for key in ("env_steps_per_s", "pipeline_frames_per_s",
                    "vs_baseline"):
            assert g[key] == w[key], (game, key)
        assert g["train_mfu_bf16_peak"] == round(3.2e13 / 7.8 / 989.5e12, 6)
        assert g["train_mfu_f32_peak"] == round(3.2e13 / 7.8 / 67e12, 6)


@pytest.mark.parametrize("index", [0, 1])
def test_device_line_names_the_card_measured(monkeypatch, index):
    """nvidia-smi lists every card of the host whatever
    CUDA_VISIBLE_DEVICES says; the row is the one with the uuid of the
    card torch runs on."""
    import subprocess
    import types

    from toybox_tpu_torch import benchmark

    uuids = ["0b1c2d3e-0000-1111-2222-333344445555",
             "9f8e7d6c-5555-4444-3333-222211110000"]
    rows = ("GPU-0b1c2d3e-0000-1111-2222-333344445555, "
            "NVIDIA H100 80GB HBM3, 700.00 W\n"
            "GPU-9f8e7d6c-5555-4444-3333-222211110000, "
            "NVIDIA H100 80GB HBM3, 500.00 W\n")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(uuid=uuids[index]))
    monkeypatch.setattr(subprocess, "run", lambda *a, **kw:
                        types.SimpleNamespace(stdout=rows))
    want = ["NVIDIA H100 80GB HBM3, 700.00 W",
            "NVIDIA H100 80GB HBM3, 500.00 W"][index]
    assert benchmark.device_line("cuda:0") == want
    assert benchmark.device_line("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(uuid="other"))
    with pytest.raises(RuntimeError, match="no card with uuid"):
        benchmark.device_line("cuda:0")


def test_update_flops_are_the_analytic_nature_cnn_count():
    env, _, _, flops = bench_torch.build_train("breakout", 1, "cpu")
    nbatch = 1 * bench_torch.TRAIN_NSTEPS
    assert env.num_actions == 4
    fwd = nature_cnn_flops(env.num_actions)
    assert fwd == 18_691_072
    assert flops == jmfu.ppo_update_flops(fwd, nbatch, noptepochs=4)
    assert flops == fwd * nbatch * 13


def test_units_a_rep_equal_bench_formula(monkeypatch):
    """Each timed window takes 1 s on a stubbed clock, so a rate is the
    units of one rep; bench.py's formulas with the JAX env's
    frames_per_step."""
    from toybox_tpu.envs.pipeline import make_rl_env as jax_make_rl_env

    ticks = iter(range(1000))
    monkeypatch.setattr(bench_torch, "clock", lambda dev: float(next(ticks)))
    n_envs, n_steps = 4, 3
    jax_fps = jax_make_rl_env("breakout", n_envs).frames_per_step
    assert bench_torch.bench_env_steps(n_envs=n_envs, n_steps=n_steps,
                                       reps=2, device="cpu") == \
        n_envs * n_steps
    assert bench_torch.bench_pipeline(n_envs=n_envs, n_steps=n_steps,
                                      reps=2, device="cpu") == \
        n_envs * n_steps * jax_fps
    monkeypatch.setattr(bench_torch, "timed_update",
                        lambda train_step, state, dev: (state, 1.0))
    jax_grid_fps = jax_make_rl_env("gridworld", 1).frames_per_step
    train = bench_torch.bench_train("gridworld", n_envs=1, reps=2,
                                    device="cpu")
    assert train["train_frames_per_s"] == 1 * 128 * jax_grid_fps


@pytest.mark.parametrize("variant,kwargs,per_sample", [
    ("f32", {}, 18_691_072),
    ("bf16", {"network_kwargs": {"dtype": "bfloat16"}}, 18_691_072),
    ("im2col", {"network": "cnn_im2col"}, 18_691_072),
    # the convolutions' output channels padded: the padded work is counted
    ("coutpad", {"network": "cnn_coutpad"}, 47_272_960),
    ("mb2", {"microbatches": 2}, 18_691_072)])
def test_step_timing_variants(variant, kwargs, per_sample):
    """scripts/ppo_step_timing.py's variants build make_ppo with these
    arguments; each counts its own program's FLOPs."""
    assert step_timing.variant_kwargs(variant) == kwargs
    _, _, _, flops = bench_torch.build_train("breakout", 1, "cpu", **kwargs)
    assert flops == per_sample * 128 * 13


def test_step_timing_runs_tiny(capsys, monkeypatch):
    monkeypatch.setattr(step_timing, "UPDATES", 1)
    out = step_timing.main(["gridworld", "1", "mb2", "--device", "cpu"])
    assert len(out["update_ms"]) == 1 and out["best_ms"] > 0
    assert out["train_frames_per_s"] > 0 and out["flops_per_update"] > 0
    assert out["device"] == "cpu"
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("update 0:") and lines[1].startswith("[mb2]")
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    with pytest.raises(ValueError):
        step_timing.variant_kwargs("f16")


def test_behavior_matrix_runs_tiny(tmp_path):
    md, js = tmp_path / "m.md", tmp_path / "m.json"
    matrix = port_matrix.main([
        "--games", "space_invaders", "--families", "ppo", "--episodes", "1",
        "--max-frames", "8", "--device", "cpu", "--out-md", str(md),
        "--out-json", str(js)])
    assert json.loads(js.read_text()) == matrix
    cells = matrix["ppo"]["space_invaders"]
    assert set(cells) == {"NoShields", "JitterVary", "ShieldXs"}
    for c in cells.values():
        assert len(c["scores"]) == 1 and np.isfinite(c["scores"]).all()
    assert "| ppo |" in md.read_text()


def test_behavior_matrix_json_matches_jax(tmp_path, monkeypatch):
    """Both packages' games replaced by one fake (the control scores 2,
    an intervened scenario 1 an episode): the cells, their keys, the
    checks' verdicts and the means are the JAX script's."""
    from toybox_tpu.sample_tests import runner as jrunner
    from toybox_tpu_torch.sample_tests import runner as prunner

    def fake(game, cfg_js, st_js, *, n_episodes, **kw):
        return np.full(n_episodes, 2.0 if cfg_js is None else 1.0,
                       np.float32)

    monkeypatch.setattr(jrunner, "play_batched", fake)
    monkeypatch.setattr(prunner, "play_batched", fake)
    jax_matrix = _load(ROOT / "scripts" / "behavior_matrix.py",
                       "jax_behavior_matrix")
    args = ["--games", "space_invaders", "--families", "ppo,a2c",
            "--episodes", "2", "--max-frames", "8"]
    monkeypatch.setattr(sys, "argv", ["behavior_matrix.py", *args,
                                      "--out-md", str(tmp_path / "j.md"),
                                      "--out-json", str(tmp_path / "j.json")])
    jax_matrix.main()
    got = port_matrix.main([*args, "--device", "cpu",
                            "--out-md", str(tmp_path / "p.md"),
                            "--out-json", str(tmp_path / "p.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "p.json").read_text()) == got == want


if __name__ == "__main__":
    # JAX's XLA count of the same forward (bench.py's yardstick)
    import jax
    import jax.numpy as jnp

    from toybox_tpu.envs.pipeline import make_rl_env
    from toybox_tpu.rl.ppo import make_ppo

    env = make_rl_env("breakout", 8)
    init_fn, _, act_fn = make_ppo(env, total_updates=100)
    state = init_fn(0)
    fwd = jmfu.network_fwd_flops(
        act_fn, state.params,
        jnp.zeros((256,) + tuple(env.obs_shape), jnp.uint8),
        jax.random.PRNGKey(0))
    analytic = nature_cnn_flops(env.num_actions)
    print(f"XLA {fwd:.0f} a sample, analytic {analytic}, "
          f"{100 * (fwd / analytic - 1):+.2f} %")

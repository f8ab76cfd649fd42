"""Multi-process runs of the port on the CPU (the counterpart of
tests/test_distributed.py, which is opt-in for JAX; these are small, so
they always run):

- the two-process launcher ``python -m toybox_tpu_torch.parallel.dryrun``
  (env phase: the global sums and the ranks' env states equal one
  process's past a game over; train phase: one sharded PPO update within
  rtol 2e-4, atol 1e-6 of one process's);
- ``run.py --multi_host`` under ``torchrun`` (two processes): each runs
  its own learn with its seed offset by rank, and only rank 0 logs and
  saves, as JAX's ``run.train`` does.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_two_process_launcher_env_and_train_phases():
    proc = subprocess.run(
        [sys.executable, "-m", "toybox_tpu_torch.parallel.dryrun",
         "--device", "cpu", "--phases", "env,train", "--steps", "128",
         "--timeout", "60"],
        cwd=REPO, capture_output=True, text=True, timeout=90, env=_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] is True and result["world"] == 2
    checks = result["checks"]
    assert checks["env_global_sums"]["ok"]
    assert checks["env_state_bit_equal"]["ok"]
    assert checks["env_game_over"]["ok"]             # past a game over
    assert checks["train_params_close"]["ok"]
    assert checks["train_params_close"]["detail"] <= 1e-6


def test_multi_host_trains_one_learn_per_process_under_torchrun(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "toybox_tpu_torch.run",
           "--multi_host", "--alg=ppo", "--env=GridWorldToyboxNoFrameskip-v4",
           "--num_envs=2", "--nsteps=4", "--nminibatches=2",
           "--noptepochs=1", "--num_timesteps=64", "--network=cnn_small",
           "--device=cpu", f"--save_path={tmp_path / 'm.model'}",
           f"--log_path={tmp_path / 'log'}"]
    env = _env()
    env["TOYBOX_LOG_FORMAT"] = "csv"
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "m.model").exists()           # rank 0 saved
    rows = (tmp_path / "log" / "progress.csv").read_text().splitlines()
    assert len(rows) == 1 + 2                        # header + 2 updates
    assert sorted(os.listdir(tmp_path)) == ["log", "m.model"]


def test_multi_host_offsets_the_seed_and_keeps_rank_0_alone(tmp_path,
                                                            monkeypatch):
    """What each process of --multi_host hands its learn, on rank 1 of
    two (the group and the learn stubbed)."""
    import torch
    import torch.distributed as dist

    from toybox_tpu_torch import run
    from toybox_tpu_torch.parallel import mesh

    calls = {}
    monkeypatch.setattr(mesh, "initialize_distributed",
                        lambda **kw: calls.setdefault("init", kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def learn(**kw):
        calls["learn"] = kw
        return "state"

    monkeypatch.setattr(run, "get_learn_function",
                        lambda alg: (learn, {"network": "cnn"}))
    args = run.common_arg_parser().parse_args(
        ["--multi_host", "--seed=5", "--num_envs=16",
         f"--save_path={tmp_path / 'm'}", f"--log_path={tmp_path / 'l'}"])
    state, lg = run.train(args, {})
    kw = calls["learn"]
    assert state == "state" and kw["seed"] == 5 + 16
    assert kw["save_path"] is None and kw["device"] == "cuda:1"  # 3 % 2
    assert calls["init"] == {"backend": "nccl"}
    assert lg.output_formats == [] and lg.get_dir() != str(tmp_path / "l")
    assert not (tmp_path / "l").exists()


@pytest.mark.parametrize("multi_host", [False, True])
def test_single_process_run_is_rank_0(tmp_path, monkeypatch, multi_host):
    """Without a launcher (--multi_host at one process, or no flag) the
    process logs and saves with its own seed, as JAX's does."""
    from toybox_tpu_torch import run
    calls = {}

    def learn(**kw):
        calls.update(kw)

    monkeypatch.setattr(run, "get_learn_function",
                        lambda alg: (learn, {}))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--seed=3", "--device=cpu", f"--save_path={tmp_path / 'm'}",
            f"--log_path={tmp_path / 'l'}"] + (
        ["--multi_host"] if multi_host else [])
    _, lg = run.train(run.common_arg_parser().parse_args(argv), {})
    assert calls["seed"] == 3 and calls["save_path"] == str(tmp_path / "m")
    assert lg.get_dir() == str(tmp_path / "l")

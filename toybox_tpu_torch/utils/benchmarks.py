"""Named benchmark suites (port of toybox_tpu.utils.benchmarks, plain
python) — reference baselines/bench/benchmarks.py
(register_benchmark / get_benchmark / list_benchmarks with task lists like
Atari10M). Tasks carry the env id, trial count, and step budget consumed
by sweep scripts (scripts/train_all.sh)."""

from __future__ import annotations

_BENCHMARKS = {}


def register_benchmark(benchmark: dict) -> None:
    name = benchmark["name"]
    if name in _BENCHMARKS:
        raise ValueError(f"benchmark {name!r} already registered")
    _BENCHMARKS[name] = benchmark


def get_benchmark(name: str) -> dict:
    try:
        return _BENCHMARKS[name]
    except KeyError:
        raise ValueError(
            f"unknown benchmark {name!r}; have {sorted(_BENCHMARKS)}")


def list_benchmarks():
    return sorted(_BENCHMARKS)


def get_task(benchmark: dict, env_id: str):
    return next((t for t in benchmark["tasks"]
                 if t["env_id"] == env_id), None)


_TOYBOX_GAMES = ["Breakout", "Amidar", "SpaceInvaders"]


def _tasks(num_timesteps, trials=6):
    return [{"env_id": f"{g}ToyboxNoFrameskip-v4", "trials": trials,
             "num_timesteps": int(num_timesteps)} for g in _TOYBOX_GAMES]


register_benchmark({
    "name": "Toybox10M",
    "description": "3 intervenable Atari games @ 10M timesteps "
                   "(the reference's Atari10M scale, run.sh:1-8)",
    "tasks": _tasks(1e7),
})

register_benchmark({
    "name": "Toybox50M",
    "description": "3 intervenable Atari games @ 50M timesteps "
                   "(the reference's 5e7 sweeps)",
    "tasks": _tasks(5e7),
})

register_benchmark({
    "name": "ToyboxQuick",
    "description": "smoke-scale training check (1M timesteps, 1 trial)",
    "tasks": _tasks(1e6, trials=1),
})

register_benchmark({
    "name": "ToyboxRegress",
    "description": "behavioral regression gate inputs "
                   "(regress.py threshold 50, 10 games each)",
    "tasks": _tasks(1e7, trials=1),
})


# ---------------------------------------------------------------------------
# Non-Toybox suites from the reference registry (bench/benchmarks.py:35-120).
# Registered for surface parity — their env ids need ale_py / mujoco, which
# this environment can't run; get_benchmark still serves the task lists to
# sweep tooling that filters on availability.
# ---------------------------------------------------------------------------

_ATARI7 = ["BeamRider", "Breakout", "Enduro", "Pong", "Qbert", "Seaquest",
           "SpaceInvaders"]
_ATARI_EXPL7 = ["Freeway", "Gravitar", "MontezumaRevenge", "Pitfall",
                "PrivateEye", "Solaris", "Venture"]
_MUJOCO_SMALL = ["InvertedDoublePendulum-v2", "InvertedPendulum-v2",
                 "HalfCheetah-v2", "Hopper-v2", "Walker2d-v2",
                 "Reacher-v2", "Swimmer-v2"]


def _atari_tasks(games, num_timesteps, trials):
    return [{"env_id": f"{g}NoFrameskip-v4", "desc": g, "trials": trials,
             "num_timesteps": int(num_timesteps)} for g in games]


register_benchmark({
    "name": "Atari10M",
    "description": "7 Atari games (Mnih et al. 2013), pixel obs, 10M "
                   "timesteps [requires ale_py]",
    "tasks": _atari_tasks(_ATARI7, 1e7, trials=6),
})

register_benchmark({
    "name": "Atari50M",
    "description": "7 Atari games (Mnih et al. 2013), pixel obs, 50M "
                   "timesteps [requires ale_py]",
    "tasks": _atari_tasks(_ATARI7, 5e7, trials=2),
})

register_benchmark({
    "name": "AtariExploration10M",
    "description": "7 exploration-heavy Atari games, 10M timesteps "
                   "[requires ale_py]",
    "tasks": _atari_tasks(_ATARI_EXPL7, 1e7, trials=2),
})

register_benchmark({
    "name": "Mujoco1M",
    "description": "small 2D MuJoCo tasks, 1M timesteps [requires mujoco]",
    "tasks": [{"env_id": e, "trials": 6, "num_timesteps": int(1e6)}
              for e in _MUJOCO_SMALL],
})

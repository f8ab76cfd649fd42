"""FPS benchmark harness (port of toybox_tpu.benchmark, the reference
test/benchmark.py methodology): raw-engine and gym-wrapped frame rates
over repeated trials, reported as mean +/- sem with the wrapper's
slowdown, and the batched env's scaling sweep.

    python -m toybox_tpu_torch.benchmark [--game breakout] [--reps 5]
        [--steps 2000] [--batch-sizes 256,2048,8192] [--device cuda]

It prints one line per measurement and then the whole result as one JSON
object, with the keys of the JAX package's. Every clock read on a CUDA
device follows a ``torch.cuda.synchronize()``, so a rate counts finished
device work. The gym-wrapped rate needs gymnasium: where it is missing
the harness says so and leaves that rate out.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _mean_sem(xs):
    xs = np.asarray(xs, float)
    sem = xs.std(ddof=1) / np.sqrt(len(xs)) if len(xs) > 1 else 0.0
    return float(xs.mean()), float(sem)


def _clock(device) -> float:
    """The host clock after the device has finished its queued work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def bench_raw_engine(game: str, steps: int, reps: int, device="cuda"):
    """Single-env step loop through the Toybox facade (the analog of the
    reference's raw ctoybox loop): (mean, sem) frames/s."""
    from toybox_tpu_torch import Toybox

    tb = Toybox(game, device=device)
    tb.apply_ale_action(1)
    for _ in range(10):
        tb.apply_ale_action(0)  # warm up
    rates = []
    for _ in range(reps):
        t0 = _clock(device)
        for _ in range(steps):
            tb.apply_ale_action(0)
        rates.append(steps / (_clock(device) - t0))
    return _mean_sem(rates)


_GYM_NAMES = {"breakout": "Breakout", "amidar": "Amidar",
              "space_invaders": "SpaceInvaders", "gridworld": "GridWorld"}


def bench_gym_wrapped(game: str, steps: int, reps: int, device="cuda"):
    """Through the port's gymnasium env and the DeepMind stack (the
    reference's gym-wrapped measurement): (mean, sem) agent steps/s, or
    None, said aloud, where gymnasium is not installed."""
    try:
        import gymnasium  # noqa: F401
    except ImportError:
        print("gym-wrapped benchmark skipped: gymnasium is not installed")
        return None
    from toybox_tpu_torch.envs.wrappers import make_atari, wrap_deepmind

    env = wrap_deepmind(make_atari(f"{_GYM_NAMES[game]}ToyboxNoFrameskip-v4",
                                   device=device), frame_stack=True)
    env.reset(seed=0)
    rates = []
    for _ in range(reps):
        t0 = _clock(device)
        for i in range(steps):
            _, _, term, trunc, _ = env.step(i % env.action_space.n)
            if term or trunc:
                env.reset()
        rates.append(steps / (_clock(device) - t0))
    env.close()
    return _mean_sem(rates)


def bench_batched(game: str, n_envs: int, steps: int, reps: int,
                  device="cuda"):
    """The batched env (obs_mode "none": state only) stepped ``steps``
    times with NOOPs per trial: (mean, sem) env steps/s over ``reps``
    trials after one warm-up trial."""
    from toybox_tpu_torch.envs.batched import make_batched_env

    fns = make_batched_env(game, n_envs, obs_mode="none", device=device)
    actions = torch.zeros(n_envs, dtype=torch.long, device=device)
    state, _ = fns.reset(torch.arange(n_envs, device=device))

    def rollout(st):
        for _ in range(steps):
            st = fns.step(st, actions)[0]
        return st

    state = rollout(state)
    rates = []
    for _ in range(reps):
        t0 = _clock(device)
        state = rollout(state)
        rates.append(n_envs * steps / (_clock(device) - t0))
    return _mean_sem(rates)


def bench_ale(game: str, steps: int, reps: int):
    """The comparative arm of the reference methodology: the same raw and
    gym-wrapped loops on the real ALE emulator, so the report can state
    the Toybox-vs-ALE speed ratio. Needs ale_py; returns None with a loud
    message when it is absent."""
    try:
        import ale_py  # noqa: F401
        import gymnasium
    except ImportError:
        print("ALE comparison skipped: ale_py is not installed "
              "(pip install ale-py gymnasium[atari] to enable)")
        return None

    name = {"breakout": "Breakout", "amidar": "Amidar",
            "space_invaders": "SpaceInvaders"}.get(game)
    if name is None:
        print(f"ALE comparison skipped: no ALE analog for {game!r}")
        return None
    from toybox_tpu_torch.envs.wrappers import wrap_deepmind

    raw = gymnasium.make(f"ALE/{name}-v5", frameskip=1,
                         repeat_action_probability=0.0)
    raw.reset(seed=0)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(steps):
            _, _, term, trunc, _ = raw.step(i % raw.action_space.n)
            if term or trunc:
                raw.reset()
        rates.append(steps / (time.perf_counter() - t0))
    raw.close()
    raw_m, raw_s = _mean_sem(rates)

    env = wrap_deepmind(gymnasium.make(f"{name}NoFrameskip-v4"),
                        frame_stack=True)
    env.reset(seed=0)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(steps // 4):
            _, _, term, trunc, _ = env.step(i % env.action_space.n)
            if term or trunc:
                env.reset()
        rates.append((steps // 4) / (time.perf_counter() - t0))
    env.close()
    gym_m, gym_s = _mean_sem(rates)
    return {"raw_engine_fps": {"mean": raw_m, "sem": raw_s},
            "gym_wrapped_fps": {"mean": gym_m, "sem": gym_s}}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--game", default="breakout")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch-sizes", default="256,2048,8192")
    parser.add_argument("--skip-gym", action="store_true")
    parser.add_argument("--compare-ale", action="store_true",
                        help="also benchmark real ALE (needs ale_py) and "
                             "report the Toybox/ALE speed ratio")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    out = {"game": args.game}
    # the single-env modes are bound by per-call dispatch: cap their loops
    single_steps = min(args.steps, 300)
    raw_m, raw_s = bench_raw_engine(args.game, single_steps, args.reps,
                                    args.device)
    out["raw_engine_fps"] = {"mean": raw_m, "sem": raw_s}
    print(f"raw engine:   {raw_m:,.0f} +/- {raw_s:,.0f} fps")

    gym = None if args.skip_gym else bench_gym_wrapped(
        args.game, single_steps // 4, args.reps, args.device)
    if gym is not None:
        gym_m, gym_s = gym
        out["gym_wrapped_fps"] = {"mean": gym_m, "sem": gym_s}
        slowdown = 100.0 * (1.0 - gym_m * 4 / max(raw_m, 1e-9))
        out["gym_wrapper_slowdown_pct"] = slowdown
        print(f"gym wrapped:  {gym_m:,.0f} +/- {gym_s:,.0f} agent-steps/s "
              f"({slowdown:.1f}% slowdown vs raw frames)")

    if args.compare_ale:
        ale = bench_ale(args.game, single_steps, args.reps)
        if ale is not None:
            out["ale"] = ale
            ratio = raw_m / max(ale["raw_engine_fps"]["mean"], 1e-9)
            out["toybox_vs_ale_raw_ratio"] = ratio
            print(f"ALE raw:      {ale['raw_engine_fps']['mean']:,.0f} fps "
                  f"(toybox/ale = {ratio:.2f}x)")

    for n in [int(x) for x in args.batch_sizes.split(",") if x]:
        m, s = bench_batched(args.game, n, max(args.steps // 8, 64),
                             args.reps, args.device)
        out[f"batched_{n}_fps"] = {"mean": m, "sem": s}
        print(f"batched n={n:<6d} {m:,.0f} +/- {s:,.0f} env-steps/s")

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

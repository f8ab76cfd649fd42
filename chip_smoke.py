#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (toybox_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line with its own wall time:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the Breakout frame kernel with nvcc;
  3. the kernel against its plain PyTorch version on the card, single and
     fused frames, at N = 10 (the serve), 256 and 1024 envs: exactly equal;
     kernel, plain and bound times at N = 1024;
  4. the engine stepped on cuda and on cpu from the same seeds and actions
     for 200 steps: every state tensor bit-equal; the pipeline and the
     policy on cuda and on cpu: rewards equal, observations within 1 grey
     level, logits and values within 1e-4;
  5. serve (the main path): the committed Breakout PPO model through the
     regress entry point, 10 games for at most 1000 agent steps; the frame
     kernels must have launched and the games must score;
  6. throughput: 1024 envs x 100 pipeline steps with the policy;
  7. a short torch.profiler window at 10 and 1024 envs: device kernels
     and device busy time per agent step.

Then a JSON line of the kernels, the total time, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Convolutions and matmuls run in full f32 (TF32 off).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from toybox_tpu_torch.core.actions import ale_to_input
from toybox_tpu_torch.envs.batched import make_batched_env
from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.games import breakout as bk
from toybox_tpu_torch.ops import render_cuda
from toybox_tpu_torch.regress import full_f32, play_games
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.rl.policies import build_eval_policy

MODEL = Path(__file__).resolve().parent / "models" / "Breakout.regress.model"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM f32 rate outside the tensor cores
SERVE_GAMES, SERVE_STEPS = 10, 1000
THROUGHPUT_ENVS, THROUGHPUT_STEPS = 1024, 100
ENGINE_ENVS, ENGINE_STEPS = 256, 200
PIPELINE_ENVS, PIPELINE_STEPS = 10, 40
PROFILE_STEPS = 10


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def phase(n: int, name: str, t0: float, detail: str) -> None:
    print(f"phase {n} {name}: {detail} ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms over iters launches (after warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def engine_states(cfg: bk.Config, n: int, steps: int, seed: int):
    """Two consecutive state batches from the port engine after random
    play: balls in play, bricks knocked out, env 0's paddle moved up, one
    env in every 7 waiting to serve."""
    r = np.random.default_rng(seed)
    s = bk.new_game(cfg, torch.arange(n, device=cfg.device) + seed)
    legal = np.asarray(bk.LEGAL_ACTIONS)
    for i in range(steps):
        a = np.where(i % 10 == 0, 1, r.choice(legal, n))
        s = bk.step(cfg, s, ale_to_input(torch.as_tensor(a, device=cfg.device)))
    alive = s.brick_alive & torch.as_tensor(
        r.random((n, bk.MAX_BRICKS)) > 0.3, device=cfg.device)
    py = s.paddle_y.clone()
    py[0] = 120.0
    wait = torch.zeros(n, dtype=torch.bool, device=cfg.device)
    wait[::7] = True
    s = s.replace(brick_alive=alive, paddle_y=py, reset=s.reset | wait)
    s2 = bk.step(cfg, s, ale_to_input(
        torch.as_tensor(r.choice(legal, n), device=cfg.device)))
    return s, s2


def kernel_phase(cfg: bk.Config):
    """Exact comparison at the main path's shapes; times at N = 1024."""
    lumas = render_cuda.breakout_lumas(cfg)
    s1, s2 = engine_states(cfg, THROUGHPUT_ENVS, 60, seed=1)
    check(int((s1.ball_alive & ~s1.reset[:, None]).sum()) > 0,
          "no ball in play in the kernel test states")
    err = {"breakout_frame": 0, "breakout_frame_fused": 0}
    preps = {}
    for n in (SERVE_GAMES, 256, THROUGHPUT_ENVS):
        p1 = render_cuda.breakout_prep(_rows(s1, n))
        p2 = render_cuda.breakout_prep(_rows(s2, n))
        for name, prep in (("breakout_frame", p1[:, None]),
                           ("breakout_frame_fused",
                            torch.stack([p1, p2], 1))):
            got = render_cuda.render_frames(prep, lumas)
            want = render_cuda.frame_plain(prep, lumas)
            torch.cuda.synchronize()
            diff = int((got.int() - want.int()).abs().max())
            check(diff == 0, f"{name} differs from its plain version by "
                             f"{diff} at N={n}")
            err[name] = max(err[name], diff)
            preps[name] = prep
    timing = {}
    for name, prep in preps.items():
        frames = prep.shape[1]
        n_bytes = prep.numel() * 4 + prep.shape[0] * bk.HEIGHT * bk.WIDTH
        # one select per pixel and frame, one max per pixel for two frames
        n_ops = prep.shape[0] * bk.HEIGHT * bk.WIDTH * (2 * frames - 1)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        timing[name] = dict(
            ms=cuda_ms(lambda: render_cuda.render_frames(prep, lumas)),
            plain_ms=cuda_ms(lambda: render_cuda.frame_plain(prep, lumas)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            n=prep.shape[0])
    return err, timing


def _rows(s: bk.State, n: int) -> bk.State:
    return bk.State(**{f: getattr(s, f)[:n] for f in bk.FIELDS})


def engine_phase() -> str:
    """Batched engine (with auto-reset) on cuda and on cpu, bit-equal."""
    envs = {d: make_batched_env("breakout", ENGINE_ENVS,
                                fast_auto_reset=True, device=d)
            for d in ("cuda", "cpu")}
    seeds = np.arange(ENGINE_ENVS) + 100
    states = {}
    for d, env in envs.items():
        st, _ = env.reset(torch.as_tensor(seeds, device=d))
        # half the envs start with the low rows gone, so their balls reach
        # the deep rows early and take the speed-up rescale
        low = (st.game.brick_depth < 3) & (torch.arange(ENGINE_ENVS,
                                                        device=d) % 2 == 0
                                           )[:, None]
        game = st.game.replace(brick_alive=st.game.brick_alive & ~low)
        states[d] = dataclasses.replace(st, game=game)
    r = np.random.default_rng(7)
    n_done = 0
    for i in range(ENGINE_STEPS):
        a = r.choice(4, size=ENGINE_ENVS, p=[.2, .4, .2, .2])
        out = {}
        for d, env in envs.items():
            states[d], _, rew, done, _ = env.step(
                states[d], torch.as_tensor(a, device=d))
            out[d] = (rew, done)
        if i % 10 == 9 or i == ENGINE_STEPS - 1:
            for f in bk.FIELDS:
                g, c = (getattr(states[d].game, f).cpu() for d in
                        ("cuda", "cpu"))
                check(torch.equal(g, c), f"engine field {f} differs between "
                                         f"cuda and cpu at step {i}")
            for k in (0, 1):
                check(torch.equal(out["cuda"][k].cpu(), out["cpu"][k]),
                      f"reward/done differ between cuda and cpu at step {i}")
            check(torch.equal(states["cuda"].seeds.cpu(),
                              states["cpu"].seeds), "reseeds differ")
        n_done += int(out["cpu"][1].sum())
    g = states["cpu"].game
    speed = torch.sqrt(g.ball_vx ** 2 + g.ball_vy ** 2)
    fast = int(((speed > 3.0) & g.ball_alive).any(1).sum())
    check(fast > 0, "no env took the speed-up rescale")
    return (f"{ENGINE_ENVS} envs x {ENGINE_STEPS} steps bit-equal; "
            f"{fast} envs with fast balls, {n_done} game overs, "
            f"score {int(g.score.sum())}")


def _policy_run(state_dict, n: int, device: str):
    env = make_rl_env("breakout", n, device=device)
    module, p_step = build_eval_policy("ppo", env.obs_shape, env.num_actions,
                                       "cnn", device=device)
    module.load_state_dict(state_dict)
    return env, module, p_step


def pipeline_phase(state_dict) -> str:
    """The DeepMind pipeline and the policy on cuda against cpu, on the
    same seeds and actions: reward, done and lives exact, observations
    within 1 grey level (the warp's matmul sums in another order), logits
    and values within 1e-4 on the same observations."""
    n = PIPELINE_ENVS
    runs = {d: _policy_run(state_dict, n, d) for d in ("cuda", "cpu")}
    states = {d: run[0].reset(torch.arange(n, device=d))[0]
              for d, run in runs.items()}
    r = np.random.default_rng(5)
    obs_diff, logit_diff, reward = 0, 0.0, 0.0
    for i in range(PIPELINE_STEPS):
        a = r.choice(4, size=n, p=[.2, .4, .2, .2])
        out = {}
        for d, (env, _, _) in runs.items():
            states[d], obs, rew, done, info = env.step(
                states[d], torch.as_tensor(a, device=d))
            out[d] = (obs, rew, done, info["lives"])
        for k in (1, 2, 3):
            check(torch.equal(out["cuda"][k].cpu(), out["cpu"][k]),
                  f"pipeline reward/done/lives differ at step {i}")
        obs_diff = max(obs_diff, int((out["cuda"][0].cpu().int()
                                      - out["cpu"][0].int()).abs().max()))
        reward += float(out["cpu"][1].sum())
        with torch.no_grad():
            obs = out["cpu"][0]
            lc, vc = runs["cuda"][1](obs.cuda())
            lp, vp = runs["cpu"][1](obs)
        logit_diff = max(logit_diff, float((lc.cpu() - lp).abs().max()),
                         float((vc.cpu() - vp).abs().max()))
    check(obs_diff <= 1, f"pipeline obs differ by {obs_diff} grey levels")
    check(logit_diff <= 1e-4, f"policy differs by {logit_diff}")
    return (f"pipeline {n} envs x {PIPELINE_STEPS} steps: reward/done/lives "
            f"equal (reward {reward}), obs max diff {obs_diff}; policy "
            f"max diff {logit_diff:.2e}")


def throughput_phase(state_dict, kernel_ms: float) -> str:
    """1024 envs x 100 pipeline steps with the policy sampling actions."""
    n = THROUGHPUT_ENVS
    env, _, p_step = _policy_run(state_dict, n, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    st, _ = env.reset(torch.arange(n, device="cuda"))
    for _ in range(3):
        actions, _, _, _ = p_step(st.frames, gen)
        st, _, _, _, _ = env.step(st, actions)
    torch.cuda.synchronize()
    before = render_cuda.LAUNCHES["breakout_frame_fused"]
    t1 = time.perf_counter()
    for _ in range(THROUGHPUT_STEPS):
        actions, _, _, _ = p_step(st.frames, gen)
        st, obs, _, _, _ = env.step(st, actions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    fused = render_cuda.LAUNCHES["breakout_frame_fused"] - before
    check(tuple(obs.shape) == (n, 84, 84, 4), f"obs shape {obs.shape}")
    share = fused * kernel_ms / (wall * 1e3)
    return (f"{n} envs x {THROUGHPUT_STEPS} steps in {wall:.3f} s: "
            f"{n * THROUGHPUT_STEPS * 4 / wall:.0f} frames/s, "
            f"{n * THROUGHPUT_STEPS / wall:.0f} agent-steps/s; fused kernel "
            f"~{100 * share:.2f}% of the time ({fused} launches x phase-3 "
            f"kernel time)")


def profile_phase(state_dict, n: int, steps: int) -> str:
    """Device time of `steps` agent steps (policy + pipeline) at n envs,
    from torch.profiler's CUDA kernel records, against the same window's
    wall time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    env, _, p_step = _policy_run(state_dict, n, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    st, _ = env.reset(torch.arange(n, device="cuda"))

    def window(st):
        for _ in range(steps):
            actions, _, _, _ = p_step(st.frames, gen)
            st, _, _, _, _ = env.step(st, actions)
        torch.cuda.synchronize()
        return st

    st = window(st)
    t1 = time.perf_counter()
    st = window(st)
    wall_us = (time.perf_counter() - t1) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window(st)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return (f"{n} envs: {wall_us / steps / 1e3:.2f} ms/agent step; "
                "device time not measured (no CUDA records)")
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    frame = sum(e.time_range.elapsed_us() for e in kernels
                if "breakout_frame" in e.name)
    return (f"{n} envs: {wall_us / steps / 1e3:.2f} ms/agent step, "
            f"{len(kernels) / steps:.0f} device kernels/step, device busy "
            f"{busy / steps:.0f} us/step ({100 * busy / wall_us:.1f}% of the "
            f"unprofiled step), frame kernel {frame / steps:.1f} us/step")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    full_f32()

    # 1. the card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    phase(1, "device", t0, f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    lib_path, log = render_cuda.build()
    render_cuda.load_library()
    ptxas = " | ".join(line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line)
    phase(2, "build", t0, f"{lib_path.name} [{ptxas or 'cached'}]")

    # 3. kernel against plain
    t0 = time.perf_counter()
    cfg = bk.default_config("cuda")
    err, timing = kernel_phase(cfg)
    detail = "; ".join(
        f"{k} N={v['n']}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f}"
        f" ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
        for k, v in timing.items())
    phase(3, "kernel", t0, f"exact at N={SERVE_GAMES},256,{THROUGHPUT_ENVS};"
          f" {detail}")

    # 4. engine, pipeline and policy: cuda against cpu
    state_dict = load_state_dict(MODEL)
    t0 = time.perf_counter()
    phase(4, "engine", t0,
          engine_phase() + "; " + pipeline_phase(state_dict))

    # 5. serve: the main path
    t0 = time.perf_counter()
    chunks = []
    for k in render_cuda.LAUNCHES:
        render_cuda.LAUNCHES[k] = 0
    scores = play_games("breakout", state_dict, "cnn", SERVE_GAMES,
                        chunk=100, max_frames=4 * SERVE_STEPS,
                        on_chunk=lambda steps, tot: chunks.append(
                            (steps, float(tot.sum()))))
    torch.cuda.synchronize()
    launches = dict(render_cuda.LAUNCHES)
    dt = time.perf_counter() - t0
    steps = chunks[-1][0]
    check(all(v > 0 for v in launches.values()),
          f"a frame kernel did not launch in the serve: {launches}")
    check(float(scores.sum()) > 0 and np.isfinite(scores).all(),
          f"serve scored {scores.tolist()}")
    so_far = " ".join(f"{k}:{v:g}" for k, v in chunks)
    phase(5, "serve", t0, f"{SERVE_GAMES} games, {steps} agent steps, "
          f"total score so far by agent step {so_far}; scores "
          f"{scores.tolist()}, mean {float(scores.mean()):.1f}, "
          f"{steps / dt:.1f} agent-steps/s, launches {launches}")

    # 6. throughput
    t0 = time.perf_counter()
    phase(6, "throughput", t0, throughput_phase(
        state_dict, timing["breakout_frame_fused"]["ms"]))

    # 7. device profile of a short window of the serve and of throughput
    t0 = time.perf_counter()
    phase(7, "profile", t0, "; ".join(
        profile_phase(state_dict, n, PROFILE_STEPS)
        for n in (SERVE_GAMES, THROUGHPUT_ENVS)))

    source = "toybox_tpu_torch/csrc/breakout_frame.cu"
    replaces = {"breakout_frame": "toybox_tpu/ops/render_pallas.py:307",
                "breakout_frame_fused": "toybox_tpu/ops/render_pallas.py:324"}
    kernels = [dict(name=k, route="cuda", source=source, replaces=replaces[k],
                    launches=launches[k], max_abs_err=err[k],
                    ms=timing[k]["ms"], plain_ms=timing[k]["plain_ms"],
                    bound_ms=timing[k]["bound_ms"],
                    bound_by=timing[k]["bound_by"], library_ms=None)
               for k in render_cuda.LAUNCHES]
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (toybox_tpu_torch) on one GPU.

    python3 chip_smoke.py

It drives the paths of the port through the entry points a user
calls: the regress (serving) path of each frame-kernel game (Breakout,
Space Invaders, Amidar) with the game's committed PPO model, PPO training
(``rl.ppo.learn``) over the pipeline's in-kernel warp, at the Breakout
recipe (1024 envs, NatureCNN, nsteps 128, 4 minibatches, 4 epochs),
every other learner (phases 18-21), the rest of the env layer:
Gridworld, the batched env's obs modes, the state samplers, seed-state
extraction and the gym surface, and the tools (phase 21).
Phases, each printing one line per game with its own wall time:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every frame kernel (csrc/*.cu) with nvcc, all at once, and
     load both entry points of each (frames, warped fused frames);
  3. each kernel against its plain PyTorch version on the card, single,
     fused and warped fused frames, at N = 10 (the serve), 256 and 1024
     envs, on random play and on doctored edge-case states:
     exactly equal; at N = 1024 the kernel's own device time
     (torch.profiler), the call's time (CUDA events, host dispatch
     included), the plain version's and the bound, and for the warp form
     the time of the path it replaces (fused kernel, then the two-matmul
     warp); Breakout's warp form also exact and timed at N = WIDE_ENVS
     (2 048, phase 8's width);
  4. the batched engine stepped on cuda and on cpu from the same seeds
     and actions: every state tensor bit-equal; the pipeline and the
     policy on cuda and on cpu: rewards equal, observations within 1 grey
     level, logits and values within 1e-4; the pipeline with
     inkernel_warp=True against False on the card: rewards, done and
     lives equal, observations within 1 grey level; Breakout's training
     pipeline (in-kernel warp, GAME_OVER_ENVS envs, one-life games) on
     cuda and on cpu until 90 % of the envs have finished a game, every
     engine field, reseed, frame stack, reward, done and finished game
     equal after every step (scripts/train_path_vs_cpu.py's E1); the
     Space Invaders configs the frame kernel refuses (SI_REFUSED) on the
     plain render route, make_rl_env(use_pallas=False), on cuda and on
     cpu: every engine field bit-equal, observations within 1 grey level
     after every step, no frame kernel launched, use_pallas True and
     "auto" raising;
  5. serve (a main path): the committed PPO model through the regress
     entry point, 10 games for at most SERVE_STEPS agent steps, with the
     launch counts set to 0 just before and read just after; the game's
     frame kernels must have launched and the games must score;
  6. throughput: THROUGHPUT_ENVS envs x THROUGHPUT_STEPS pipeline steps
     with the policy;
  7. a short torch.profiler window at 10 and 1024 envs: device kernels
     and device busy time per agent step;
  8. train (the slice's main path): ``learn`` on make_rl_env(game, 1024,
     inkernel_warp=True), one update at the Breakout recipe and one shorter
     update (nsteps TRAIN_SHORT_STEPS) for Space Invaders and Amidar, with
     the launch counts set to 0 just before each and read just after:
     Breakout's warp kernel launches 128 times; metrics finite;
     seconds per update and frames/s; then one more Breakout update,
     train_step's collect and optimize halves timed apart, profiled (the
     warp kernel's device time a rollout step); then the JAX package's
     documented 2 048-env PPO: ``run.main --num_envs=2048
     --microbatches=2`` for one update at the recipe (the launch counts
     set to 0 just before and read just after: 128 warp launches, finite
     metrics; seconds, frames/s, collect and optimize and their peak
     device memory), and one collected 2 048-env batch through
     scripts/train_path_vs_cpu.py's ``take_apart``: three updates from
     the same Adam state and permutations (microbatches=1, the same from
     params x (1 + 1e-7 N(0, 1)), microbatches=2), each with its seconds
     and peak memory: microbatches=2 held to the rule of
     WIDE_MOVE_SHARE's comment;
  9. one PPO update on cuda against cpu from the same params, batch and
     permutations: params within UPDATE_ATOL; then UPDATE_TRAIN_STEPS
     whole train_steps of make_ppo on each device, each collecting its
     own rollout from the cpu's draws (scripts/train_path_vs_cpu.py's
     E2): rollouts equal, flips near ties, params within UPDATE_ATOL;
 10. the identity learning test on the card (mlp, 16 envs, 60 updates):
     mean reward > 0.8;
 11. the CLI: ``toybox_tpu_torch.run.main`` trains one update at 64 envs
     and saves the policy, which reads back through the port's reader;
 12. behavior (a main path, the gate of the intervention API): each
     behavioral scenario's set-up captured on the card (config and state
     JSON equal to the same capture on the CPU), N = 10 and 256 envs
     started from it by ``reset_to`` and played at random, the single
     and fused frame kernels and the warp form exactly equal to their
     plain versions on those states (no shields, moved shields, 0 and 1
     enemies, one brick, a channel, one serve position); then ``run_all_gated`` with
     the committed ppo models, cut in depth (GATE_EPISODES episodes of
     at most GATE_MAX_FRAMES frames), the launch counts set to 0 just
     before and read just after: the game's frame kernels must have
     launched and every score must be finite (pass/fail at this depth is
     printed, not required);
 13. heads (a main path, the serve of every committed model): each of
     the 37 checkpoints in models/ loaded strictly into its eval head
     (``rl.eval_adapter``) on the card and on the cpu, both fed one uint8
     batch (N = HEADS_N, numpy seed 0): logits and value or Q within
     HEADS_ATOL of the cpu's (scaled by the output's largest magnitude
     above 1), and for recurrent heads also the carry over HEADS_T steps
     with envs done at t = HEADS_DONE_AT; then one serve chunk (the
     regress entry point, HEADS_GAMES envs x HEADS_STEPS agent steps) with
     the launch counts set to 0 just before and read just after: the
     game's single and fused kernels must have launched; the mean raw
     score so far is printed. Then the single-env adapter
     (``make_tb_policy``) on the card's facade against the cpu's, one
     model a game: the same stacks within 1 grey level, its frames from
     the single-frame kernel.
 14. Gridworld (the game with no frame kernel: its frames are the plain
     render's, as in the JAX package): GRID_ENVS envs x GRID_ENGINE_STEPS
     random steps, every engine state tensor bit-equal between cuda and
     cpu; make_rl_env("gridworld", GRID_ENVS) for GRID_PIPE_STEPS steps on
     both, obs within 1 grey level, rewards, dones and lives equal; ms an
     agent step and the device-busy share (phase 7's window, a random cnn
     policy); then ``run.main --alg=ppo
     --env=GridWorldToyboxNoFrameskip-v4`` at GRID_ENVS envs, two updates
     of GRID_NSTEPS steps: finite losses, the model saved and read back;
 15. obs modes, each game: make_batched_env(obs_mode=m) for m in
     grayscale, rgba, rgb with auto_reset on and off, at OBS_EXACT_ENVS
     envs x OBS_EXACT_STEPS steps exactly equal to the cpu's (obs, rewards,
     dones); BatchedEnv equal to the functional env; each mode timed at
     OBS_TIME_ENVS envs (ms a step, peak memory) beside obs_mode="none";
     for the frame-kernel games, the pipeline steps with the engine's
     render refused (its inner env renders nothing);
 16. state tools: fit_models on a Breakout trajectory played on the
     card's facade, sample_state and write_state_json (equal to the cpu's
     load), each committed seed-state fixture's predicate after load on
     cuda, and extract_seed_state with the committed ppo1 model for
     life_lost (at most SEED_STATE_FRAMES frames a seed): the predicate
     holds on the state it returns; frame index and ms a frame;
 17. the gym surface (gym.make of the four namespaced ids,
     wrap_deepmind(make_atari(...)), make_vec_env at OBS_TIME_ENVS envs),
     only where gymnasium is installed; elsewhere one line says it was not
     driven and why.

 18. learners (a main path of each): ``run.main`` trains and saves, on
     the pipeline's in-kernel warp, a2c with cnn at its recipe (Breakout,
     32 envs x nsteps 5, one block of 16 updates), a2c with cnn_lstm (4
     updates), ppo with cnn_lstm (one update at the PPO recipe, 1 024 envs
     x nsteps 128, 4 x 4 minibatches), ppo with cnn_lnlstm on Space
     Invaders (one update at nsteps 32) and acktr at its recipe (32 envs x
     nsteps 20, invert_every 16, kfac_clip 0.01, 2 updates), the launch
     counts set to 0 just before each and read just after: the game's
     single and warped fused kernels must have launched (the warp once an
     agent step); ms an update, collect and optimize timed apart to a
     sync; the device-busy share of one more collect (at most
     LEARNER_PROFILE_ENVS envs) and optimize; frames/s and the recipe's
     projected hours; each saved file read back through
     ``load_eval_params`` equal. Then the K-FAC inverses timed alone, and
     one update of each learner on cuda against cpu from the same params
     and batch (LEARNER_CHECK_ENVS envs): params within each learner's
     stated tolerance.
 19. replay learners (a main path of each): ``run.main`` trains and
     saves, on the pipeline's in-kernel warp, deepq on Space Invaders at
     its recipe (8 envs, train_freq 2, batch 64, a prioritized dueling
     double-Q ring of 10 000; one block of 64 cycles, learning_starts
     cut to 64 so that SGD and a target sync run), acer cnn_small on
     Breakout (16 envs x nsteps 20, 2 blocks of 2 cycles, so replay
     runs), acer cnn_lstm on Space Invaders (one block of 2 cycles) and
     trpo on Space Invaders (16 envs x nsteps 512, one update), each
     checked as phase 18 checks its runs (the warp kernel once an agent
     step: train_freq, nsteps or 512 an update); then the optimize half
     of one deepq cycle, one acer cycle (with replay) and one trpo update
     on cuda against cpu from the same params, ring or batch and draws.
 20. imitation and continuous control (a main path of each):
     ``run.main`` trains and saves, on the pipeline's in-kernel warp,
     ppo1 on Amidar at its recipe (256 envs x 256 steps, minibatches of
     4 096, one update) and GAIL on Breakout at its recipe (64 envs,
     NatureCNN, max_kl 0.001, the expert models/Breakout.ppo1.model) cut
     in depth: 4 096 expert transitions at stride 2, 2 BC epochs, nsteps
     32, two updates at g_step 2 (the second takes the d-step); each
     checked as phase 18 checks its runs, the warp kernel once an agent
     step of the rollouts and of GAIL's expert extraction, whose time
     and BC's are reported apart. Then ``ddpg.learn`` on the box identity
     env at the JAX learning test's settings (8 envs, 600 cycles): its
     mean reward above the test's threshold (-0.35), ms a cycle, the
     busy share; ``run.main --alg=ddpg`` raises JAX's ValueError. Then
     one ppo1 update, one GAIL-TRPO update with its d-step and one DDPG
     cycle on cuda against cpu from the same params, batch and draws.
 21. goal learners and tools (a main path of each): HER at its published
     widths (GoalQNet 256-256, actor and critic 3 x 256) and the JAX
     learning tests' settings: ``make_her`` (16 envs, 6 bits, 400 cycles)
     succeeds above 0.5; ``make_her_ddpg`` with the future strategy and
     without relabeling (16 envs, dim 2, 150 cycles each): the mean
     success of the last 20 cycles above 0.5 and below 0.25, 0.3 apart;
     ``her.learn`` with each backend at its defaults (125 cycles); ms a
     cycle and the busy share of 5 more; ``run.main --alg=her`` raises
     JAX's ValueError. Then one cycle of each on cuda against cpu from the
     same state and draws (the params whose gradient is not float noise,
     the first step's gradients, the losses); each action distribution's
     neglogp, entropy, kl and mode on cuda against cpu; one PPO update
     (cnn_small) on the image-class env on cuda against cpu; and
     ``benchmark.main`` for Breakout (--reps 3 --steps 100 --batch-sizes
     256,2048,8192), its JSON on a line of its own.
 22. distributed (a main path of the distributed layer): (a)
     ``parallel.dryrun.dryrun_multichip(1)`` on a one-rank NCCL group on
     the card (PPO, DQN with its sharded ring, ACKTR with its all-reduced
     K-FAC taps, one step each on tiny shapes, the envs as JAX's dryruns
     build them: the fused max-pool kernel and the matmul warp), each
     against the same step without a group (params within rtol 2e-4,
     atol 1e-6), and ``ppo.learn(mesh=)`` for one update on the in-kernel
     warp against ``ppo.learn`` without a group (the same tolerance);
     (b) the two-process launcher, two gloo ranks on the one card: the
     env phase's global sums and env states equal one process's past
     every env's game over (DIST_STEPS steps of one-life games), the
     params after one sharded PPO update within rtol 2e-4, atol 1e-6 of
     one process's, the DQN sharded sample's slots equal the single
     ring's; (c) cnn_im2col and cnn_coutpad forward on the card within
     HEADS_ATOL (scaled) of the cpu's. The seconds of each part, the
     backend and the frame kernels' launches of (a) and of (b)'s ranks.

Then a JSON line of the kernels (``launches`` from the serve or the train
phase; for Breakout's warp form also ``wide``, its phase-3 figures at
2 048 envs, and ``wide_launches``, phase 8's 2 048-env run;
``gate_launches`` from phase 12, ``heads_launches`` summed over
phase 13's serve chunks, ``learner_launches`` summed over the runs of
phases 18, 19 and 20; phase 21 runs no frame kernel;
``distributed_launches`` from phase 22), the total time,
and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Convolutions and matmuls run in full f32 (TF32 off). Scratch files (the
CLI's log and model) go under build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from toybox_tpu_torch import Toybox, run
from toybox_tpu_torch.core.actions import ale_to_input
from toybox_tpu_torch.envs.batched import BatchedEnv, make_batched_env
from toybox_tpu_torch.envs.pipeline import FRAME_KERNEL_GAMES, make_rl_env
from toybox_tpu_torch.games import amidar as am
from toybox_tpu_torch.games import breakout as bk
from toybox_tpu_torch.games import get_game
from toybox_tpu_torch.games import gridworld as gw
from toybox_tpu_torch.games import space_invaders as si
from toybox_tpu_torch.games.common import luma2d
from toybox_tpu_torch.interventions.models import fit_models, sample_state
from toybox_tpu_torch.ops import obs, render_amidar, render_cuda, render_si
from toybox_tpu_torch.regress import full_f32, play_games
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.checkpoint import load_state_dict
from toybox_tpu_torch.rl.eval_adapter import (checkpoint_head, eval_head,
                                              make_tb_policy)
from toybox_tpu_torch.rl.models import RECURRENT_NETWORKS
from toybox_tpu_torch.rl.policies import build_eval_policy, build_policy
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env
from toybox_tpu_torch.run_get_seed_state import (PREDICATES,
                                                 extract_seed_state)
from toybox_tpu_torch.sample_tests import get_scenarios
from toybox_tpu_torch.sample_tests.families import overrides_for
from toybox_tpu_torch.sample_tests.runner import capture_setup, run_all_gated

ROOT = Path(__file__).resolve().parent
MODELS = ROOT / "models"
SCRATCH = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM f32 rate outside the tensor cores
SERVE_GAMES, SERVE_STEPS = 10, 100
TRAIN_ENVS, TRAIN_UPDATES, TRAIN_SHORT_STEPS = 1024, 1, 32
RECIPE = dict(network="cnn", nsteps=128, nminibatches=4, noptepochs=4,
              lr=2.5e-4, cliprange=0.1, gamma=0.99, lam=0.95,
              ent_coef=0.01)                 # run.ALG_DEFAULTS["ppo"]
UPDATE_ENVS, UPDATE_STEPS, UPDATE_ATOL = 8, 8, 1e-5
UPDATE_TRAIN_STEPS = 2            # phase 9: whole train_steps, cuda vs cpu
# phase 4: Breakout's training pipeline past game overs (one-life games),
# at least the first many agent steps, at most the second
GAME_OVER_ENVS, GAME_OVER_STEPS = 128, (40, 150)
CLI_ENVS, CLI_UPDATES = 64, 1
# phase 8: the JAX package's documented 2 048-env PPO with gradients
# accumulated over microbatches (README: --num_envs=2048 --microbatches=2),
# and the rule for its update against microbatches=1 (PERF.md, section 6):
# every strong weight (first gradient above 1e-3 of its tensor's largest)
# within WIDE_MOVE_SHARE of the update's largest move, and each metric
# within rtol WIDE_RTOL of mb1's or twice its difference in the same
# update from params x (1 + 1e-7 N(0, 1)). Each limit is the geometric
# mean of the largest sound reading and the smallest reading of a fault
# planted in ppo.update on this batch (scripts/train_path_vs_cpu.py
# --part microbatches on an H100): params 1.47 % (cuDNN's other kernels
# for 32 768 rows) against 42.7 % (a chunk left out); metrics 1.27e-5
# against 1.77e-4 (each chunk's advantages normalised alone, which moves
# the params less than the sound arms do)
WIDE_ENVS, WIDE_MICROBATCHES, WIDE_MOVE_SHARE, WIDE_RTOL = 2048, 2, 0.08, 5e-5
# phase 4: Space Invaders configs the SI frame kernel refuses, played on
# the plain render route (make_rl_env(use_pallas=False)); the last shield
# of each lies under the ship's first shots
SI_REFUSED = {"four shields": [[84, 157], [148, 157], [212, 157], [60, 157]],
              "two rows": [[84, 157], [60, 120]]}
REFUSED_ENVS, REFUSED_STEPS = 64, 16
WARP = 84
THROUGHPUT_ENVS, THROUGHPUT_STEPS = 1024, 30
ENGINE_ENVS, ENGINE_STEPS = 256, 150
AMIDAR_ENGINE_STEPS = 400     # its one-life games end only after ~300 steps
PIPELINE_ENVS, PIPELINE_STEPS = 10, 20
PROFILE_STEPS = 2
BEHAVIOR_ENVS, BEHAVIOR_FRAMES = (SERVE_GAMES, 256), 40
GATE_EPISODES, GATE_MAX_FRAMES = 2, 128
HEADS_N, HEADS_T, HEADS_DONE_AT, HEADS_ATOL = 32, 8, 4, 1e-4
HEADS_GAMES, HEADS_STEPS, ADAPTER_FRAMES = 10, 8, 16
KERNEL_ENVS = (SERVE_GAMES, 256, THROUGHPUT_ENVS)
# the depths of phases 4, 14 and 15 (engine, pipeline and exact steps; the
# engine's Breakout and Space Invaders runs cut from 200 to 150 steps, phase
# 6's from 50 to 30 and phase 7's windows from 3 to 2 steps when phases 4
# and 9 took on the training path's game overs and train_steps), of
# phase 5's serve, phase 6's throughput, phase 7's profile windows, phase
# 12's gate, phase 13's serve chunks and phase 16's extraction, of phase
# 8's and phase 11's updates and of the learner runs of phases 18 and 19
# are cut to keep the whole run under 540 s (PERF.md, section 4)
GRID_ENVS, GRID_ENGINE_STEPS, GRID_PIPE_STEPS, GRID_NSTEPS = 1024, 50, 12, 32
OBS_MODES = ("grayscale", "rgba", "rgb")
OBS_EXACT_ENVS, OBS_EXACT_STEPS = 64, 10
OBS_TIME_ENVS, OBS_STEPS = 1024, 10
STATE_FRAMES, SEED_STATE_FRAMES, GYM_STEPS = 60, 1500, 100
SEED_STATE_SEEDS = (0, 1, 2, 3)
# phase 22: envs in all (split over the ranks), the env phase's steps, the
# sharded update against one process's (tests/test_parallel.py's
# tolerance), and each group's and spawned rank's time limit in seconds
DIST_ENVS, DIST_STEPS, DIST_TOL, DIST_TIMEOUT = 8, 128, (2e-4, 1e-6), 240
FIXTURES = ROOT / "tests" / "fixtures" / "seed_states"
DEV = "cuda"
T_START = time.perf_counter()
PALLAS = "toybox_tpu/ops/render_pallas.py"


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def phase(n: int, name: str, t0: float, detail: str) -> None:
    now = time.perf_counter()
    print(f"phase {n} {name}: {detail} ({now - t0:.2f} s; "
          f"{now - T_START:.0f} s in)", flush=True)


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


def kernel_ms(fn, symbol: str, iters: int = 20, windows: int = 3) -> float:
    """Mean device time in ms of one launch of the CUDA kernel whose name
    holds `symbol`, from torch.profiler's kernel records over iters calls
    of fn() (after warm-up). The profiler may drop records, so the mean is
    over the records it kept, and a window in which it kept none is
    profiled again, up to `windows` in all; it fails if none kept one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and symbol in e.key]
        seen = sum(e.count for e in rows)
        if seen > 0:
            return sum(e.device_time_total for e in rows) / seen / 1e3
    check(False, f"the profiler kept no record of {symbol} in {windows} "
                 "windows")


def _rows(module, s, n: int):
    return module.State(**{f: getattr(s, f)[:n] for f in module.FIELDS})


def _random_play(module, cfg, n, steps, seed, fire_every=10, start=None):
    """States after `steps` frames of random play (FIRE every
    `fire_every` frames), from new games or from `start(state)`."""
    r = np.random.default_rng(seed)
    s = module.new_game(cfg, torch.arange(n, device=cfg.device) + seed)
    if start is not None:
        s = start(s)
    legal = np.asarray(module.LEGAL_ACTIONS)
    for i in range(steps):
        a = np.where(i % fire_every == 0, 1, r.choice(legal, n))
        s = module.step(cfg, s, ale_to_input(torch.as_tensor(
            a, device=cfg.device)))
    return s, r


def _next(module, cfg, s, r):
    return module.step(cfg, s, ale_to_input(torch.as_tensor(
        r.choice(np.asarray(module.LEGAL_ACTIONS), s.score.shape[0]),
        device=cfg.device)))


def breakout_states(cfg, n: int, seed: int):
    """Balls in play, bricks knocked out, env 0's paddle moved up, one env
    in every 7 waiting to serve."""
    s, r = _random_play(bk, cfg, n, 60, seed)
    alive = s.brick_alive & torch.as_tensor(
        r.random((n, bk.MAX_BRICKS)) > 0.3, device=cfg.device)
    py = s.paddle_y.clone()
    py[0] = 120.0
    wait = torch.zeros(n, dtype=torch.bool, device=cfg.device)
    wait[::7] = True
    s = s.replace(brick_alive=alive, paddle_y=py, reset=s.reset | wait)
    check(int((s.ball_alive & ~s.reset[:, None]).sum()) > 0,
          "no ball in play in the kernel test states")
    return s, _next(bk, cfg, s, r)


def si_states(cfg, n: int, seed: int):
    """The formation marching and thinned, lasers in flight, shields
    eroded, the UFO over the formation in one env in 5, the ship down in
    one env in 7."""
    def start(s):
        return s.replace(life_display_timer=torch.ones_like(s.lives))

    s, r = _random_play(si, cfg, n, 300, seed, fire_every=3, start=start)
    ufo = torch.zeros(n, dtype=torch.bool, device=cfg.device)
    ufo[::5] = True
    down = torch.zeros(n, dtype=torch.bool, device=cfg.device)
    down[::7] = True
    s = s.replace(
        ufo_appearance_counter=torch.where(ufo, 0, s.ufo_appearance_counter),
        ufo_x=torch.where(ufo, torch.as_tensor(
            r.integers(-10, 320, n), device=cfg.device,
            dtype=torch.int32), s.ufo_x),
        ship_alive=s.ship_alive & ~down,
        ship_death_counter=torch.where(down, -1, s.ship_death_counter))
    check(not bool(s.shield_alpha.all()), "no shield eroded")
    check(int((s.ship_laser_alive | s.elaser_alive.any(1)).sum()) > 0,
          "no laser in flight in the kernel test states")
    return s, _next(si, cfg, s, r)


def amidar_states(cfg, n: int, seed: int):
    """Tiles painted, enemies on their routes, a random third of the
    boxes painted (their interiors draw)."""
    s, r = _random_play(am, cfg, n, 150, seed)
    painted = s.box_painted | torch.as_tensor(
        r.random((n, am.MAX_BOXES)) > 0.7, device=cfg.device)
    s = s.replace(box_painted=painted)
    check(int((s.tiles == am.PAINTED).sum()) > int(
        (cfg.base_tiles == am.PAINTED).sum()) * n, "no tile painted")
    return s, _next(am, cfg, s, r)


def _cases(n: int, count: int, shift: int):
    """Env index masks of `count` cases, env i taking case
    (i + shift) % count."""
    case = (np.arange(n) + shift) % count
    return [case == k for k in range(count)]


def breakout_edge_fields(f: dict, shift: int = 0) -> dict:
    """Doctored Breakout states, as edits of a batch's fields (numpy
    arrays, the engine's State fields) -> the edited fields. Env i takes
    case (i + shift) % 8: the paddle straddling and past each frame edge
    and wall, its y moved by an intervention (0, 157, 300 and fractional),
    balls on fractional and integer edges and far off the frame (+-1e6),
    balls overlapping each other and the paddle, over bricks and over
    walls, balls hidden by `reset` and by `ball_alive`, all bricks gone in
    one env and all present in another."""
    f = {k: np.array(v) for k, v in f.items()}
    c = _cases(f["paddle_x"].shape[0], 8, shift)
    # (paddle x, width, y) and four balls (x, y) per case
    cases = [
        # 0: the paddle over the left and top frame edges; balls on the
        # left, right and bottom edges, at fractional coordinates
        ((5.0, 24.0, 0.0), [(-0.5, 20.0), (0.5, 60.0), (239.5, 100.0),
                            (120.0, 159.5)]),
        # 1: the paddle over the right and bottom edges; balls far off
        ((236.0, 24.0, 157.0), [(1e6, 50.0), (-1e6, 50.0), (100.0, 1e6),
                                (100.0, -1e6)]),
        # 2: two balls overlapping each other and the paddle, one on the
        # paddle's edge, one over the left wall
        ((100.0, 24.0, 143.0), [(100.0, 144.5), (101.5, 145.0),
                                (111.3, 142.7), (6.2, 90.0)]),
        # 3: the paddle past the right edge; balls over bricks, the top
        # wall and the right wall
        ((300.0, 24.0, 100.0), [(50.5, 45.0), (200.0, 130.0),
                                (20.0, 16.5), (233.7, 80.2)]),
        # 4: the paddle past the left edge; the balls waiting to be served
        ((-30.0, 24.0, 50.0), [(60.0, 60.0), (70.0, 70.0), (80.0, 80.0),
                               (90.0, 90.0)]),
        # 5: the paddle from x = 0 exactly over the left wall, straddling
        # the top wall at a fractional y; no ball alive
        ((12.0, 24.0, 14.5), [(60.0, 60.0), (70.0, 70.0), (80.0, 80.0),
                              (90.0, 90.0)]),
        # 6: all bricks gone; the paddle over the right wall and past the
        # bottom; balls on integer edges: the frame's corners and the
        # brick band's
        ((228.0, 24.0, 300.0), [(2.0, 2.0), (238.0, 158.0), (12.0, 43.0),
                                (228.0, 139.0)]),
        # 7: all bricks present; a paddle wider than the frame over the top
        # edge; balls over the top-left and bottom-right corners and over
        # the paddle
        ((120.0, 1000.0, -2.0), [(3.5, 0.5), (236.5, 159.0), (116.0, 1.0),
                                 (-1.5, 158.5)]),
    ]
    for k, ((px, width, py), balls) in enumerate(cases):
        f["paddle_x"][c[k]] = px
        f["paddle_width"][c[k]] = width
        f["paddle_y"][c[k]] = py
        f["ball_x"][c[k]] = [x for x, _ in balls]
        f["ball_y"][c[k]] = [y for _, y in balls]
        f["ball_alive"][c[k]] = k != 5
        f["reset"][c[k]] = k == 4
    f["brick_alive"][c[6]] = False
    f["brick_alive"][c[7]] = f["brick_exists"][c[7]]
    return f


def si_edge_fields(f: dict, shift: int = 0) -> dict:
    """Doctored Space Invaders states, as edits of a batch's fields (numpy
    arrays, the engine's State fields) -> the edited fields. Env i takes
    case (i + shift) % 8: sprites straddling each frame edge and past it,
    the formation anchor pushing cells past the left, right, top and
    bottom edges (and far off the frame), lasers over the ship and over
    the shields, half-eroded shields, hidden sprites."""
    f = {k: np.array(v) for k, v in f.items()}
    c = _cases(f["ufo_x"].shape[0], 8, shift)
    n_sh = f["shield_alpha"].shape[1]

    def put(name, case, value, col=slice(None)):
        a = f[name]
        if a.ndim == 1:
            a[case] = value
        else:
            a[case, col] = value

    for k, (ax, ay) in enumerate([(-40, 20), (250, -20), (3, 150), (-60, 40),
                                  (290, 100), (-300, 500), (1, -107),
                                  (319, 209)]):
        put("enemy_x", c[k], ax, 0)
        put("enemy_y", c[k], ay, 0)
    show = np.arange(36) % 5 != 2               # a thinned formation
    f["enemy_alive"][c[0] | c[1] | c[4]] = show
    f["enemy_death_counter"][c[0] | c[1] | c[4]] = -1
    # case 0: UFO over the left edge, ship over the right, lasers over the
    # top and bottom edges and past the right
    put("ufo_appearance_counter", c[0], 0)
    put("ufo_x", c[0], -7)
    put("ufo_y", c[0], 30)
    put("ship_alive", c[0], True)
    put("ship_x", c[0], 312)
    put("ship_y", c[0], 185)
    put("elaser_alive", c[0], True)
    for j, (x, y) in enumerate([(100, -3), (120, 206), (321, 50), (-2, 60)]):
        put("elaser_x", c[0], x, j)
        put("elaser_y", c[0], y, j)
    # case 1: UFO past the top, ship over the bottom edge, UFO over the
    # formation
    put("ufo_appearance_counter", c[1], 0)
    put("ufo_x", c[1], 150)
    put("ufo_y", c[1], -12)
    put("ship_alive", c[1], True)
    put("ship_x", c[1], 0)
    put("ship_y", c[1], 205)
    # case 2: lasers over the ship, the ship at the left edge
    put("ship_alive", c[2], True)
    put("ship_x", c[2], 40)
    put("ship_y", c[2], 185)
    put("ship_laser_alive", c[2], True)
    put("ship_laser_x", c[2], 47)
    put("ship_laser_y", c[2], 183)
    put("elaser_alive", c[2], True)
    for j, (x, y) in enumerate([(40, 190), (54, 180), (38, 186), (55, 194)]):
        put("elaser_x", c[2], x, j)
        put("elaser_y", c[2], y, j)
    # case 3: lasers over the shields, the shields half eroded
    put("ship_laser_alive", c[3], True)
    put("ship_laser_x", c[3], 90)
    put("ship_laser_y", c[3], 160)
    put("elaser_alive", c[3], True)
    for j, (x, y) in enumerate([(147, 155), (163, 170), (226, 168),
                                (83, 172)]):
        put("elaser_x", c[3], x, j)
        put("elaser_y", c[3], y, j)
    alpha = f["shield_alpha"]
    rows = np.arange(alpha.shape[2])[:, None]
    cols = np.arange(alpha.shape[3])[None, :]
    for s in range(n_sh):
        alpha[c[3], s] &= [cols >= 8, rows < 9, (rows + cols) % 2 == 0][s % 3]
    alpha[c[4], :, :, :8] = False
    # case 4: hidden sprites over the formation and the shields
    put("ufo_appearance_counter", c[4], 5)
    put("ufo_x", c[4], 100)
    put("ufo_y", c[4], 110)
    put("ship_alive", c[4], False)
    put("ship_death_counter", c[4], -1)
    put("ship_laser_alive", c[4], False)
    put("ship_laser_x", c[4], 90)
    put("ship_laser_y", c[4], 160)
    put("elaser_alive", c[4], False)
    put("elaser_x", c[4], 300)
    put("elaser_y", c[4], 110)
    # case 5: UFO over the right edge, the ship half past the bottom
    put("ufo_appearance_counter", c[5], 0)
    put("ufo_x", c[5], 310)
    put("ufo_y", c[5], 0)
    put("ship_alive", c[5], True)
    put("ship_x", c[5], 100)
    put("ship_y", c[5], 215)
    # case 6: the top-left corner: one pixel of the UFO and of a laser
    put("ufo_appearance_counter", c[6], 0)
    put("ufo_x", c[6], -15)
    put("ufo_y", c[6], -9)
    put("elaser_alive", c[6], True)
    put("elaser_x", c[6], -1, 0)
    put("elaser_y", c[6], -7, 0)
    # case 7: the bottom-right corner, the ship dying (still drawn)
    put("ufo_appearance_counter", c[7], 0)
    put("ufo_x", c[7], 319)
    put("ufo_y", c[7], 209)
    put("ship_alive", c[7], False)
    put("ship_death_counter", c[7], 10)
    put("ship_x", c[7], 305)
    put("ship_y", c[7], 201)
    return f


def amidar_edge_fields(f: dict, shift: int = 0) -> dict:
    """Doctored Amidar states, as edits of a batch's fields (numpy arrays,
    world coordinates: pixel = origin + world // 16) -> the edited fields.
    Env i takes case (i + shift) % 6: enemies and the player straddling
    each frame edge and past it, at the board's four corners overlapping
    each other and the player, on negative and unaligned world
    coordinates, and hidden enemies on the player."""
    f = {k: np.array(v) for k, v in f.items()}
    c = _cases(f["player_x"].shape[0], 6, shift)

    def world(px, origin):
        return (np.asarray(px) - origin) * 16

    def place(case, enemies, player, exists=True):
        ex, ey = zip(*enemies)
        f["enemy_x"][case] = world(ex, 16)
        f["enemy_y"][case] = world(ey, 45)
        f["enemy_exists"][case] = exists
        f["player_x"][case] = world(player[0], 16)
        f["player_y"][case] = world(player[1], 45)

    # 0: each frame edge, straddled and passed
    place(c[0], [(-2, 100), (158, 120), (60, -3), (80, 247), (-5, 10),
                 (161, 30), (100, -6), (20, 251)], (157, -2))
    # 1: the board's top-left corner, all overlapping the player
    place(c[1], [(16, 45), (17, 45), (16, 46), (18, 47), (15, 44), (19, 49),
                 (14, 45), (16, 43)], (17, 46))
    # 2: the board's bottom-right corner (board x < 144, y < 200)
    place(c[2], [(140, 195), (141, 196), (142, 197), (143, 198), (144, 199),
                 (139, 200), (141, 195), (138, 194)], (141, 197))
    # 3: the top-right and bottom-left corners
    place(c[3], [(140, 45), (141, 44), (142, 46), (143, 43), (16, 195),
                 (15, 196), (14, 197), (17, 199)], (14, 198))
    # 4: hidden enemies on the player, one shown beside it
    place(c[4], [(70, 100)] * 7 + [(73, 103)], (70, 100),
          exists=np.arange(8) == 7)
    # 5: world coordinates that are negative and not multiples of 16
    f["enemy_x"][c[5]] = [-1, -17, -300, 5, 2047, 2049, 15, -16]
    f["enemy_y"][c[5]] = [-1, -730, 2495, 3, 15, 17, -721, 2490]
    f["enemy_exists"][c[5]] = True
    f["player_x"][c[5]] = -257
    f["player_y"][c[5]] = 2479
    return f


def _edge_states(module, edit):
    """`edit` (a function of numpy fields and a case shift) applied to a
    torch state."""
    def apply(s, shift=0):
        fields = {k: getattr(s, k).cpu().numpy() for k in module.FIELDS}
        dev = s.score.device
        return s.replace(**{k: torch.as_tensor(v, device=dev)
                            for k, v in edit(fields, shift).items()})
    return apply


@dataclasses.dataclass(frozen=True)
class Game:
    """One ported game: its engine, model, frame kernel and checks."""
    name: str
    module: object
    model: str
    kernel: str                  # csrc/<kernel>.cu
    replaces: tuple              # render_pallas.py lines: single, fused
                                 # (the warp form is the fused renderer's)
    ops: object                  # module with render_frames, frame_plain
    prep: object                 # (config, state) -> f32[N, P]
    consts: object               # config -> kernel constants
    states: object               # (config, n, seed) -> (s1, s2)
    edges: object = None         # state -> doctored state (edge cases)


GAMES = (
    Game("breakout", bk, "Breakout.regress.model", "breakout_frame",
         (307, 324), render_cuda, lambda c, s: render_cuda.breakout_prep(s),
         render_cuda.breakout_lumas, breakout_states,
         _edge_states(bk, breakout_edge_fields)),
    Game("space_invaders", si, "SpaceInvaders.regress.model", "si_frame",
         (710, 722), render_si, lambda c, s: render_si.si_prep(s),
         render_si.si_consts, si_states,
         _edge_states(si, si_edge_fields)),
    Game("amidar", am, "Amidar.regress.model", "amidar_frame", (475, 489),
         render_amidar, render_amidar.amidar_prep,
         render_amidar.amidar_consts, amidar_states,
         _edge_states(am, amidar_edge_fields)),
)


def _bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_phase(g: Game):
    """Exact comparison at the main paths' shapes, on random play and, for
    games with edge cases, on doctored states (each env's two frames take
    different cases); times at N = 1024."""
    cfg = g.module.default_config(DEV)
    consts = g.consts(cfg)
    h, w = g.module.HEIGHT, g.module.WIDTH
    tables = obs.warp_tables(h, w, WARP, DEV)
    s1, s2 = g.states(cfg, THROUGHPUT_ENVS, 1)
    sets = [("random play", s1, s2)]
    if g.edges is not None:
        sets.append(("edge cases", g.edges(s1), g.edges(s2, shift=1)))
    names = (g.kernel, g.kernel + "_fused", g.kernel + "_fused_warp")
    err = {k: 0 for k in names}
    preps = {}
    for label, a, b in sets:
        for n in KERNEL_ENVS:
            p1 = g.prep(cfg, _rows(g.module, a, n))
            p2 = g.prep(cfg, _rows(g.module, b, n))
            pair = torch.stack([p1, p2], 1)
            for name, prep, tab in zip(names, (p1[:, None], pair, pair),
                                       (None, None, tables)):
                got = g.ops.render_frames(prep, consts, tab)
                want = (g.ops.frame_plain(prep, consts) if tab is None
                        else g.ops.frame_warp_plain(prep, consts, tab))
                torch.cuda.synchronize()
                diff = int((got.int() - want.int()).abs().max())
                check(diff == 0, f"{name} differs from its plain version by "
                                 f"{diff} at N={n} on {label}")
                err[name] = max(err[name], diff)
                if label == "random play":
                    preps[name] = prep
    timing = {name: _kernel_timing(g, prep, consts,
                                   tables if name.endswith("_warp") else None)
              for name, prep in preps.items()}
    # the path the warp form replaces: the fused kernel, then two matmuls
    warp = obs.make_warp(h, w, WARP, DEV)
    pair = preps[names[1]]
    timing[names[2]]["replaced_ms"] = cuda_ms(
        lambda: warp(g.ops.render_frames(pair, consts)))
    if g.name == "breakout":
        # the warp form at the width of the 2 048-env training (phase 8b)
        a, b = g.states(cfg, WIDE_ENVS, 2)
        pairs = {label: torch.stack([g.prep(cfg, s1), g.prep(cfg, s2)], 1)
                 for label, s1, s2 in (
                     ("random play", a, b),
                     ("edge cases", g.edges(a), g.edges(b, shift=1)))}
        wide_err = 0
        for label, pair in pairs.items():
            got = g.ops.render_frames(pair, consts, tables)
            diff = int((got.int() - g.ops.frame_warp_plain(
                pair, consts, tables).int()).abs().max())
            check(diff == 0, f"{names[2]} differs from its plain version by "
                             f"{diff} at N={WIDE_ENVS} on {label}")
            wide_err = max(wide_err, diff)
        timing[names[2]]["wide"] = dict(
            _kernel_timing(g, pairs["random play"], consts, tables),
            max_abs_err=wide_err)
    return [label for label, _, _ in sets], err, timing


def _kernel_timing(g: Game, prep, consts, tab) -> dict:
    """The kernel's own time, the call's, the plain version's and the
    bound on `prep` (f32[N, frames, P]), warped with `tab` if given."""
    h, w = g.module.HEIGHT, g.module.WIDTH
    n, frames = prep.shape[0], prep.shape[1]
    # one select per pixel and frame, one max per pixel for two frames
    n_ops = n * h * w * (2 * frames - 1)
    if tab is None:
        n_bytes = prep.numel() * 4 + n * h * w
        plain = lambda: g.ops.frame_plain(prep, consts)  # noqa: E731
    else:
        # the banded sums: one multiply and one add per tap
        taps = tab.taps[:, :, 1].sum(1).tolist()
        n_ops += n * 2 * (taps[0] * w + taps[1] * WARP)
        n_bytes = prep.numel() * 4 + n * WARP * WARP
        plain = lambda: g.ops.frame_warp_plain(  # noqa: E731
            prep, consts, tab)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    call = lambda: g.ops.render_frames(prep, consts, tab)  # noqa: E731
    symbol = g.kernel + ("_warp" if tab is not None else "") + "_kernel"
    return dict(ms=kernel_ms(call, symbol), call_ms=cuda_ms(call),
                plain_ms=cuda_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
                n=n)


def _engine_start(g: Game, st, d):
    """Breakout: half the envs start with the low rows gone, so their
    balls reach the deep rows early and take the speed-up rescale. Space
    Invaders: no intro pause. Amidar and Space Invaders: one life left, so
    games end and reset inside the run."""
    game = st.game
    idx = torch.arange(ENGINE_ENVS, device=d)
    if g.name == "breakout":
        low = (game.brick_depth < 3) & (idx % 2 == 0)[:, None]
        game = game.replace(brick_alive=game.brick_alive & ~low)
    else:
        game = game.replace(lives=torch.ones_like(game.lives))
    if g.name == "space_invaders":
        game = game.replace(life_display_timer=torch.ones_like(game.lives))
    return dataclasses.replace(st, game=game)


def engine_phase(g: Game) -> str:
    """Batched engine (with auto-reset) on cuda and on cpu, bit-equal."""
    envs = {d: make_batched_env(g.name, ENGINE_ENVS, obs_mode="none",
                                fast_auto_reset=True, device=d)
            for d in (DEV, "cpu")}
    seeds = np.arange(ENGINE_ENVS) + 100
    states = {d: _engine_start(g, env.reset(torch.as_tensor(
        seeds, device=d))[0], d) for d, env in envs.items()}
    n_act = envs["cpu"].num_actions
    r = np.random.default_rng(7)
    steps = AMIDAR_ENGINE_STEPS if g.name == "amidar" else ENGINE_STEPS
    n_done = 0
    for i in range(steps):
        a = r.integers(0, n_act, size=ENGINE_ENVS)
        a[r.random(ENGINE_ENVS) < 0.3] = 1          # FIRE (or jump) often
        out = {}
        for d, env in envs.items():
            states[d], _, rew, done, _ = env.step(
                states[d], torch.as_tensor(a, device=d))
            out[d] = (rew, done)
        if i % 10 == 9 or i == steps - 1:
            for f in g.module.FIELDS:
                c, h = (getattr(states[d].game, f).cpu() for d in
                        (DEV, "cpu"))
                check(torch.equal(c, h), f"{g.name} engine field {f} differs "
                                         f"between cuda and cpu at step {i}")
            for k in (0, 1):
                check(torch.equal(out[DEV][k].cpu(), out["cpu"][k]),
                      f"{g.name} reward/done differ between cuda and cpu at "
                      f"step {i}")
            check(torch.equal(states[DEV].seeds.cpu(), states["cpu"].seeds),
                  f"{g.name} reseeds differ")
        n_done += int(out["cpu"][1].sum())
    gs = states["cpu"].game
    detail = (f"{g.name} {ENGINE_ENVS} envs x {steps} steps bit-equal; "
              f"{n_done} game overs, score {int(gs.score.sum())}")
    if g.name == "breakout":
        speed = torch.sqrt(gs.ball_vx ** 2 + gs.ball_vy ** 2)
        fast = int(((speed > 3.0) & gs.ball_alive).any(1).sum())
        check(fast > 0, "no env took the speed-up rescale")
        detail += f", {fast} envs with fast balls"
    else:
        check(n_done > 0, f"no {g.name} game ended in the engine run")
    return detail


def _policy_run(g: Game, state_dict, n: int, device: str):
    env = make_rl_env(g.name, n, device=device)
    module, p_step = build_eval_policy("ppo", env.obs_shape, env.num_actions,
                                       "cnn", device=device)
    module.load_state_dict(state_dict)
    return env, module, p_step


def pipeline_phase(g: Game, state_dict) -> str:
    """The DeepMind pipeline and the policy on cuda against cpu, on the
    same seeds and actions: reward, done and lives exact, observations
    within 1 grey level (the warp's matmul sums in another order), logits
    and values within 1e-4 on the same observations."""
    n = PIPELINE_ENVS
    runs = {d: _policy_run(g, state_dict, n, d) for d in (DEV, "cpu")}
    states = {d: run[0].reset(torch.arange(n, device=d))[0]
              for d, run in runs.items()}
    n_act = runs["cpu"][0].num_actions
    r = np.random.default_rng(5)
    obs_diff, logit_diff, reward = 0, 0.0, 0.0
    for i in range(PIPELINE_STEPS):
        a = r.integers(0, n_act, size=n)
        a[r.random(n) < 0.4] = 1
        out = {}
        for d, (env, _, _) in runs.items():
            states[d], obs, rew, done, info = env.step(
                states[d], torch.as_tensor(a, device=d))
            out[d] = (obs, rew, done, info["lives"])
        for k in (1, 2, 3):
            check(torch.equal(out[DEV][k].cpu(), out["cpu"][k]),
                  f"{g.name} pipeline reward/done/lives differ at step {i}")
        obs_diff = max(obs_diff, int((out[DEV][0].cpu().int()
                                      - out["cpu"][0].int()).abs().max()))
        reward += float(out["cpu"][1].sum())
        with torch.no_grad():
            obs = out["cpu"][0]
            lc, vc = runs[DEV][1](obs.to(DEV))
            lp, vp = runs["cpu"][1](obs)
        logit_diff = max(logit_diff, float((lc.cpu() - lp).abs().max()),
                         float((vc.cpu() - vp).abs().max()))
    check(obs_diff <= 1, f"{g.name} pipeline obs differ by {obs_diff} grey "
                         "levels")
    check(logit_diff <= 1e-4, f"{g.name} policy differs by {logit_diff}")
    return (f"{g.name} pipeline {n} envs x {PIPELINE_STEPS} steps: "
            f"reward/done/lives equal (reward {reward}), obs max diff "
            f"{obs_diff}; policy max diff {logit_diff:.2e}")


def serve_phase(g: Game, state_dict):
    """The main path: the regress entry point's play_games with the
    committed model, the launch counts set to 0 just before it and read
    just after."""
    chunks = []
    for k in render_cuda.LAUNCHES:
        render_cuda.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    scores = play_games(g.name, state_dict, "cnn", SERVE_GAMES, chunk=100,
                        device=DEV, max_frames=4 * SERVE_STEPS,
                        on_chunk=lambda steps, tot: chunks.append(
                            (steps, float(tot.sum()))))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(render_cuda.LAUNCHES)
    mine = {k: launches[k] for k in (g.kernel, g.kernel + "_fused")}
    check(all(v > 0 for v in mine.values()),
          f"a {g.name} frame kernel did not launch in the serve: {launches}")
    check(float(scores.sum()) > 0 and np.isfinite(scores).all(),
          f"{g.name} serve scored {scores.tolist()}")
    steps = chunks[-1][0]
    so_far = " ".join(f"{k}:{v:g}" for k, v in chunks)
    detail = (f"{g.name} {SERVE_GAMES} games, {steps} agent steps, total "
              f"score so far by agent step {so_far}; scores "
              f"{scores.tolist()}, mean {float(scores.mean()):.1f}, "
              f"{steps / dt:.1f} agent-steps/s, launches {launches}")
    return mine, detail


def throughput_phase(g: Game, state_dict, kernel_ms: float) -> str:
    """1024 envs x 100 pipeline steps with the policy sampling actions."""
    n = THROUGHPUT_ENVS
    env, _, p_step = _policy_run(g, state_dict, n, DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    st, _ = env.reset(torch.arange(n, device=DEV))
    for _ in range(3):
        actions, _, _, _ = p_step(st.frames, gen)
        st, _, _, _, _ = env.step(st, actions)
    torch.cuda.synchronize()
    key = g.kernel + "_fused"
    before = render_cuda.LAUNCHES[key]
    t1 = time.perf_counter()
    for _ in range(THROUGHPUT_STEPS):
        actions, _, _, _ = p_step(st.frames, gen)
        st, obs, _, _, _ = env.step(st, actions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    fused = render_cuda.LAUNCHES[key] - before
    check(tuple(obs.shape) == (n, 84, 84, 4), f"obs shape {obs.shape}")
    share = fused * kernel_ms / (wall * 1e3)
    return (f"{g.name} {n} envs x {THROUGHPUT_STEPS} steps in {wall:.3f} s: "
            f"{n * THROUGHPUT_STEPS * 4 / wall:.0f} frames/s, "
            f"{n * THROUGHPUT_STEPS / wall:.0f} agent-steps/s; fused kernel "
            f"~{100 * share:.2f}% of the time ({fused} launches x phase-3 "
            f"kernel time)")


def profile_phase(g: Game, state_dict, n: int, steps: int) -> str:
    """Device time of `steps` agent steps (policy + pipeline) at n envs,
    from torch.profiler's CUDA kernel records, against the same window's
    wall time measured without the profiler."""
    env, _, p_step = _policy_run(g, state_dict, n, DEV)
    return _profile_window(g.name, env, p_step, n, steps, g.kernel)


def _profile_window(name: str, env, p_step, n: int, steps: int,
                    kernel=None) -> str:
    """profile_phase's window on a built pipeline and policy; the frame
    kernel's time a step where ``kernel`` names one."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEV).manual_seed(0)
    st, _ = env.reset(torch.arange(n, device=DEV))

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
        return (f"{name} {n} envs: {wall_us / steps / 1e3:.2f} ms/agent "
                "step; device time not measured (no CUDA records)")
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    detail = (f"{name} {n} envs: {wall_us / steps / 1e3:.2f} ms/agent step, "
              f"{len(kernels) / steps:.0f} device kernels/step, device busy "
              f"{busy / steps:.0f} us/step ({100 * busy / wall_us:.1f}% of "
              "the unprofiled step)")
    if kernel is None:
        return detail
    frame = sum(e.time_range.elapsed_us() for e in kernels
                if kernel in e.name)
    return detail + f", frame kernel {frame / steps:.1f} us/step"


def warp_pipeline_phase(g: Game) -> str:
    """The pipeline with inkernel_warp=True against False on the card, on
    the same seeds and actions: reward, done and lives exact, observations
    within 1 grey level (the banded sums and the matmuls sum in other
    orders)."""
    n = PIPELINE_ENVS
    envs = {w: make_rl_env(g.name, n, inkernel_warp=w, device=DEV)
            for w in (True, False)}
    states = {w: e.reset(torch.arange(n, device=DEV))[0]
              for w, e in envs.items()}
    n_act = envs[True].num_actions
    r = np.random.default_rng(6)
    worst, differ = 0, 0
    for i in range(PIPELINE_STEPS):
        a = r.integers(0, n_act, size=n)
        a[r.random(n) < 0.4] = 1
        out = {}
        for w, env in envs.items():
            states[w], o, rew, done, info = env.step(
                states[w], torch.as_tensor(a, device=DEV))
            out[w] = (o, rew, done, info["lives"])
        for k in (1, 2, 3):
            check(torch.equal(out[True][k], out[False][k]),
                  f"{g.name} inkernel_warp changes reward/done/lives at "
                  f"step {i}")
        diff = (out[True][0].int() - out[False][0].int()).abs()
        worst = max(worst, int(diff.max()))
        differ += int((diff > 0).sum())
    check(worst <= 1, f"{g.name} inkernel_warp obs differ by {worst}")
    total = n * PIPELINE_STEPS * WARP * WARP * 4
    return (f"{g.name} inkernel_warp=True vs False, {n} envs x "
            f"{PIPELINE_STEPS} steps: reward/done/lives equal, obs max diff "
            f"{worst}, {differ} of {total} obs pixels differ")


def _train_path():
    """scripts/train_path_vs_cpu.py, the card's training path against the
    cpu's (its E1 and E2 at the sizes of phases 4 and 9)."""
    import importlib.util
    name = "train_path_vs_cpu"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module        # dataclasses look it up there
        spec.loader.exec_module(module)
    return sys.modules[name]


def game_over_phase() -> str:
    """Breakout's training pipeline (make_rl_env on the in-kernel warp,
    seed_stride = its envs, as ppo.learn builds it) on cuda and on cpu
    from the seeds of the cpu's init_fn(0), one-life games, the same
    random actions (FIRE often) until 90 % of the envs have finished a
    game: every engine field, the reseeds, the frame stack, lives,
    rewards, dones and the finished games equal after every step."""
    tp = _train_path()
    lo, hi = GAME_OVER_STEPS
    r = tp.e1("random", "kernel", GAME_OVER_ENVS, lo, hi, DEV, "cpu",
              lives=1, log=lambda s: None)
    check(r["first_difference"] is None,
          f"the training pipeline differs between cuda and cpu: "
          f"{r['first_difference']}")
    check(r["game_overs"] > 0, "no breakout game ended in the training "
                               "pipeline run")
    return (f"breakout training pipeline (in-kernel warp, one-life games) "
            f"{r['envs']} envs x {r['steps']} steps, cuda vs cpu equal "
            f"(engine, reseeds, stack, rewards, dones, games); "
            f"{r['game_overs']} game overs, {r['share_with_game_over']:.3f} "
            f"of the envs")


def si_refused_phase() -> str:
    """The Space Invaders configs the SI frame kernel refuses (SI_REFUSED)
    on the plain render route, make_rl_env(use_pallas=False), on cuda and
    on cpu from the same seeds and actions (the intro pause skipped, FIRE
    often): every engine field and reseed bit-equal, rewards, dones and
    lives equal and observations within 1 grey level after every step;
    no frame kernel launched; use_pallas True and "auto" raise."""
    base = si.config_to_json(si.default_config("cpu"))
    n, parts = REFUSED_ENVS, []
    _reset_launches()
    for label, shields in SI_REFUSED.items():
        d = dict(base, shields=shields)
        for use_pallas in (True, "auto"):
            try:
                make_rl_env("space_invaders", n, config=si.config_from_json(
                    d, DEV), use_pallas=use_pallas, device=DEV)
            except ValueError:
                continue
            check(False, f"use_pallas={use_pallas!r} took the {label} "
                         "config the SI frame kernel refuses")
        envs = {dev: make_rl_env("space_invaders", n,
                                 config=si.config_from_json(d, dev),
                                 use_pallas=False, device=dev)
                for dev in (DEV, "cpu")}
        states = {}
        for dev, env in envs.items():
            st = env.reset(torch.arange(n, device=dev))[0]
            game = st.env.game.replace(
                life_display_timer=torch.ones_like(st.env.game.lives))
            states[dev] = dataclasses.replace(
                st, env=dataclasses.replace(st.env, game=game))
        r = np.random.default_rng(8)
        worst, reward = 0, 0.0
        for i in range(REFUSED_STEPS):
            a = r.integers(0, envs["cpu"].num_actions, size=n)
            a[r.random(n) < 0.3] = 1
            out = {}
            for dev, env in envs.items():
                states[dev], o, rew, done, info = env.step(
                    states[dev], torch.as_tensor(a, device=dev))
                out[dev] = (o, rew, done, info["lives"])
            for k in (1, 2, 3):
                check(torch.equal(out[DEV][k].cpu(), out["cpu"][k]),
                      f"{label}: reward/done/lives differ at step {i}")
            for f in si.FIELDS:
                check(torch.equal(getattr(states[DEV].env.game, f).cpu(),
                                  getattr(states["cpu"].env.game, f)),
                      f"{label}: engine field {f} differs at step {i}")
            check(torch.equal(states[DEV].env.seeds.cpu(),
                              states["cpu"].env.seeds),
                  f"{label}: reseeds differ at step {i}")
            worst = max(worst, int((out[DEV][0].cpu().int()
                                    - out["cpu"][0].int()).abs().max()))
            reward += float(out["cpu"][1].sum())
        check(worst <= 1, f"{label}: obs differ by {worst} grey levels")
        alpha = states["cpu"].env.game.shield_alpha
        hit = int((alpha[:, -1].sum((1, 2))
                   < int(si.SHIELD_MASK.sum())).sum())
        check(hit > 0, f"{label}: no laser hit the extra shield")
        parts.append(f"{label} {shields}: {n} envs x {REFUSED_STEPS} steps "
                     f"cuda = cpu (engine, reseeds, rewards, dones, lives), "
                     f"obs max diff {worst}, reward {reward:g}, the extra "
                     f"shield eroded in {hit} envs")
    launches = {k: v for k, v in render_cuda.LAUNCHES.items() if v}
    check(not launches, f"use_pallas=False launched {launches}")
    return ("space invaders, use_pallas=False on the configs the frame "
            "kernel refuses (True and \"auto\" raise): " + "; ".join(parts)
            + "; no frame kernel launched")


class _Rows:
    """A logger for ``learn``: one dict per update, stamped with the host
    clock when the update's metrics were read (learn reads them as
    floats, which waits for the device)."""

    def __init__(self):
        self.rows, self.row = [], {}

    def logkv(self, key, value):
        self.row[key] = value

    def dumpkvs(self):
        self.row["wall"] = time.perf_counter()
        self.rows.append(self.row)
        self.row = {}


def _reset_launches() -> None:
    for k in render_cuda.LAUNCHES:
        render_cuda.LAUNCHES[k] = 0


def train_phase(g: Game, nsteps: int, updates: int):
    """A main path: ``learn`` on make_rl_env(game, TRAIN_ENVS,
    inkernel_warp=True) with the ppo defaults, the launch counts set to 0
    just before and read just after. Returns (launches, detail, seconds
    per update)."""
    env = make_rl_env(g.name, TRAIN_ENVS, inkernel_warp=True, device=DEV)
    log = _Rows()
    nbatch = TRAIN_ENVS * nsteps
    _reset_launches()
    t0 = time.perf_counter()
    state = ppo.learn(env=env, total_timesteps=updates * nbatch * 4,
                      seed=0, logger=log, device=DEV,
                      **dict(RECIPE, nsteps=nsteps))
    torch.cuda.synchronize()
    launches = dict(render_cuda.LAUNCHES)
    warp = g.kernel + "_fused_warp"
    check(launches[warp] == updates * nsteps,
          f"{warp} launched {launches[warp]} times in {updates} updates of "
          f"{nsteps} steps: {launches}")
    check(launches[g.kernel + "_fused"] == 0,
          f"the unwarped fused kernel ran on the warp path: {launches}")
    check(state.update == updates and len(log.rows) == updates,
          f"{g.name} trained {state.update} updates")
    for row in log.rows:
        for k in ppo.METRICS + ("mean_reward",):
            key = f"loss/{k}" if k in ppo.METRICS else k
            check(math.isfinite(row[key]), f"{g.name} {key} = {row[key]}")
    walls = [t0] + [row["wall"] for row in log.rows]
    secs = [b - a for a, b in zip(walls, walls[1:])]
    steady = secs[1:] if len(secs) > 1 else secs
    per_update = sum(steady) / len(steady)
    last = log.rows[-1]
    detail = (f"{g.name} {TRAIN_ENVS} envs x nsteps {nsteps}, {updates} "
              f"updates: s/update " + ", ".join(f"{x:.2f}" for x in secs)
              + f" (steady {per_update:.2f} s: "
              f"{nbatch * 4 / per_update:.0f} frames/s, "
              f"{nbatch / per_update:.0f} agent-steps/s); last update "
              + ", ".join(f"{k} {last[k]:.4g}" for k in (
                  "loss/policy_loss", "loss/value_loss",
                  "loss/policy_entropy", "loss/approxkl", "loss/clipfrac",
                  "mean_reward", "eprewmean", "episodes"))
              + f"; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
              f"launches {launches}")
    del state, env
    return launches, detail, per_update


def train_profile_phase() -> str:
    """One more Breakout update at the recipe through make_ppo's
    train_step, its two halves timed apart on the host clock, each to a
    sync: ``collect`` (the rollout and GAE) and ``optimize`` (the
    minibatch epochs). Then torch.profiler over the collect half of an
    8-step train_step and over the optimize half at the recipe (again on
    the same batch): device busy share and the largest device kernels."""
    from torch.profiler import ProfilerActivity, profile

    env = make_rl_env("breakout", TRAIN_ENVS, inkernel_warp=True, device=DEV)

    def trainer(nsteps):
        init_fn, train_step, _ = ppo.make_ppo(
            env, device=DEV, **dict(RECIPE, nsteps=nsteps))
        return init_fn(0), train_step

    state, train_step = trainer(RECIPE["nsteps"])
    t0 = time.perf_counter()
    collected = train_step.collect(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    train_step.optimize(state, collected)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    def busy(fn, label, steps=0):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e6
        ks = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if not ks:
            return f"{label}: device time not measured (no CUDA records)"
        total = sum(e.time_range.elapsed_us() for e in ks)
        by = {}
        for e in ks:
            by[e.name] = by.get(e.name, 0) + e.time_range.elapsed_us()
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        warp = sum(v for k, v in by.items() if "breakout_frame_warp" in k)
        return (f"{label}: {len(ks)} device kernels, device busy {total:.0f}"
                f" us of {wall:.0f} us profiled ({100 * total / wall:.1f}%); "
                "largest " + ", ".join(f"{k[:48]} {v:.0f} us"
                                       for k, v in top)
                + (f"; the warp kernel {warp / steps:.1f} us a rollout step"
                   if steps else ""))

    short, short_step = trainer(8)
    detail = (f"breakout {TRAIN_ENVS} envs, one train_step split: collect "
              f"({RECIPE['nsteps']} rollout steps + GAE) {t1 - t0:.2f} s, "
              f"optimize ({RECIPE['noptepochs']} epochs x "
              f"{RECIPE['nminibatches']} minibatches) {t2 - t1:.2f} s; "
              + busy(lambda: short_step.collect(short),
                     "collect of 8 rollout steps", 8) + "; "
              + busy(lambda: train_step.optimize(state, collected),
                     f"optimize, {RECIPE['noptepochs']} epochs"))
    del collected, state, short, env
    return detail


def wide_train_phase():
    """The JAX package's documented 2 048-env PPO (README: 2048 envs,
    --microbatches=2) through the CLI entry point: ``run.main --alg=ppo
    --env=BreakoutToyboxNoFrameskip-v4 --num_envs=2048 --microbatches=2``
    for one update at the recipe, the launch counts set to 0 just before
    and read just after: 128 warp kernel launches, finite metrics; its
    seconds, frames/s, collect and optimize halves and their peak device
    memory. Returns (launches, detail)."""
    log = SCRATCH / "wide"
    shutil.rmtree(log, ignore_errors=True)
    nsteps = run.ALG_DEFAULTS["ppo"]["nsteps"]
    frames = WIDE_ENVS * nsteps * 4
    _reset_launches()
    with _TimedSteps() as timed:
        state = run.main(["--alg=ppo", "--env=BreakoutToyboxNoFrameskip-v4",
                          f"--num_envs={WIDE_ENVS}",
                          f"--microbatches={WIDE_MICROBATCHES}",
                          f"--num_timesteps={frames}", f"--log_path={log}",
                          f"--device={DEV}"])
        torch.cuda.synchronize()
    launches = dict(render_cuda.LAUNCHES)
    check(state.update == 1 and len(timed.rows) == 1,
          f"the 2048-env run trained {state.update} updates")
    check(launches["breakout_frame_fused_warp"] == nsteps,
          f"breakout_frame_fused_warp launched "
          f"{launches['breakout_frame_fused_warp']} times: {launches}")
    with open(log / "progress.csv") as f:
        row = list(csv.DictReader(f))[-1]
    for k in ppo.METRICS:
        check(math.isfinite(float(row[f"loss/{k}"])),
              f"2048-env {k} = {row[f'loss/{k}']}")
    (collect, optimize), (peak_c, peak_o) = timed.rows[0], timed.peaks[0]
    return launches, (
        f"run.main --num_envs={WIDE_ENVS} --microbatches="
        f"{WIDE_MICROBATCHES}, one update at the recipe: "
        f"{collect + optimize:.2f} s ({frames / (collect + optimize):.0f} "
        f"frames/s): collect {collect:.2f} s (peak {peak_c / 2**30:.2f} "
        f"GiB), optimize {optimize:.2f} s (peak {peak_o / 2**30:.2f} GiB); "
        + ", ".join(f"{k} {float(row[f'loss/{k}']):.4g}"
                    for k in ppo.METRICS)
        + f"; launches {launches}")


def wide_update_phase() -> str:
    """One collected 2 048-env batch at the recipe taken apart by
    scripts/train_path_vs_cpu.py's ``take_apart``: the first
    minibatch's gradients (which weights are strong, and its device
    kernels), then three whole updates from the same zero Adam state
    and permutations, each with its seconds and peak device memory: mb1
    (microbatches=1), mb1' (the same from the params x (1 + 1e-7
    N(0, 1))) and mb2 (microbatches=WIDE_MICROBATCHES). mb2 is held to
    the rule of WIDE_MOVE_SHARE's comment."""
    tp = _train_path()
    mb2, p1 = f"mb{WIDE_MICROBATCHES}", "mb1'"
    r = tp.take_apart(
        WIDE_ENVS, RECIPE["nsteps"], DEV, {"mb1": tp.Arm(DEV)},
        {"mb1": tp.Arm(DEV), p1: tp.Arm(DEV, perturbed=True),
         mb2: tp.Arm(DEV, WIDE_MICROBATCHES)},
        [(p1, "mb1"), (mb2, "mb1")], [], log=lambda s: None)
    check(r["moved"] > 1e-4, f"the 2048-env update moved {r['moved']}")
    share = r["share"][f"{mb2} - mb1"]
    check(share <= WIDE_MOVE_SHARE,
          f"microbatches={WIDE_MICROBATCHES} is {share:.3g} of the update's "
          f"move {r['moved']:.3g} from microbatches=1 on the strong "
          f"weights, more than {WIDE_MOVE_SHARE:g}")
    m = {k: v["metrics"] for k, v in r["arms"].items()}
    for k in ppo.METRICS:
        off = abs(m[mb2][k] - m["mb1"][k])
        yard = abs(m[p1][k] - m["mb1"][k])
        check(off <= WIDE_RTOL * abs(m["mb1"][k]) or off <= 2 * yard,
              f"{k}: microbatches={WIDE_MICROBATCHES} {m[mb2][k]!r} against "
              f"mb1 {m['mb1'][k]!r} ({p1} within {yard:.3g})")
    apart = {k: v["all"] for k, v in r["update"].items()}
    kernels = [name for name, _ in r["kernels"]["mb1"]][:3]
    return (f"breakout {WIDE_ENVS} envs, one collected batch: the update "
            f"moved up to {r['moved']:.3g}; from mb1 on all / strong "
            "weights: " + ", ".join(
                f"{k} {v['all']:.3g} / {v['strong']:.3g} "
                f"({r['share'][k]:.3g} of the move)"
                for k, v in r["update"].items())
            + f"; rule: {mb2} strong <= {WIDE_MOVE_SHARE:g} x move; "
            f"({mb2} - mb1) / ({p1} - mb1) on all weights "
            f"{apart[mb2 + ' - mb1'] / apart[p1 + ' - mb1']:.3g}; "
            + "; ".join(f"{k} {v['seconds']:.2f} s, peak "
                        f"{v['peak'] / 2**30:.2f} GiB" for k, v in
                        r["arms"].items())
            + f"; metrics mb1 / {mb2} / {p1} " + ", ".join(
                f"{k} {m['mb1'][k]:.9g} / {m[mb2][k]:.9g} / {m[p1][k]:.9g}"
                for k in ppo.METRICS)
            + f"; the first minibatch's largest kernels {kernels}")


def update_phase() -> str:
    """One PPO update on cuda and on cpu from the same params, batch and
    permutations: a make_ppo on the cpu collects the batch (its
    train_step's collect half), then ``ppo.update`` runs on each device.
    The params after it agree within UPDATE_ATOL (cuDNN and the CPU sum
    the convolutions' gradients in other orders)."""
    n, nsteps = UPDATE_ENVS, UPDATE_STEPS
    env = make_rl_env("breakout", n, device="cpu")
    init_fn, train_step, _ = ppo.make_ppo(env, nsteps=nsteps, device="cpu")
    state = init_fn(0)
    before = {k: v.clone() for k, v in state.module.state_dict().items()}
    batch, _ = train_step.collect(state)
    module, p_init, _, _ = build_policy(env.obs_shape, env.num_actions,
                                        "cnn", device=DEV)
    p_init(0)
    for k, v in module.state_dict().items():
        check(torch.equal(v.cpu(), before[k]), f"init differs: {k}")
    mods = {DEV: module, "cpu": state.module}
    perms = [torch.randperm(n * nsteps, generator=state.generator)
             for _ in range(4)]
    hp = ppo.Hyper(nminibatches=4)
    lrnow, cliprnow = ppo.anneal(0, 1, 2.5e-4, 0.1)
    metrics = {}
    for d, module in mods.items():
        metrics[d] = ppo.update(
            module, ppo.AdamState.zeros_like(list(module.parameters())),
            tuple(x.to(d) for x in batch), [p.to(d) for p in perms],
            lrnow, cliprnow, hp, env.num_actions)
    after = {d: {k: v.cpu() for k, v in m.state_dict().items()}
             for d, m in mods.items()}
    moved = max(float((after["cpu"][k] - before[k]).abs().max())
                for k in before)
    diff = max(float((after[DEV][k] - after["cpu"][k]).abs().max())
               for k in before)
    check(moved > 1e-4, f"the update moved the params by only {moved}")
    check(diff <= UPDATE_ATOL, f"cuda and cpu updates differ by {diff}")
    mdiff = max(abs(float(metrics[DEV][k]) - float(metrics["cpu"][k]))
                for k in ppo.METRICS)
    return (f"breakout {n} envs x nsteps {nsteps}, 4 epochs x 4 "
            f"minibatches: params moved up to {moved:.3g}, cuda vs cpu max "
            f"diff {diff:.3g} (tolerance {UPDATE_ATOL:g}); metrics max diff "
            f"{mdiff:.3g}")


def train_step_phase() -> str:
    """UPDATE_TRAIN_STEPS whole train_steps of make_ppo at UPDATE_ENVS x
    UPDATE_STEPS on cuda and on cpu, the rollouts collected on each device
    from the cpu's draws (Gumbel noise, permutations; the cpu's action at
    a flip): rollouts equal, flips near ties, params within UPDATE_ATOL
    after each."""
    tp = _train_path()
    r = tp.e2(UPDATE_ENVS, UPDATE_STEPS, UPDATE_TRAIN_STEPS, DEV, "cpu",
              log=lambda s: None)
    bad = tp.faults([], r, yardstick=False)
    check(not bad, f"train_step cuda vs cpu: {bad}")
    diffs = [row["card_vs_ref"] for row in r["rows"]]
    check(max(diffs) <= UPDATE_ATOL, f"cuda and cpu train_steps differ by "
                                     f"{diffs}")
    return (f"{UPDATE_TRAIN_STEPS} train_steps, each device's collect from "
            f"the cpu's draws: rollouts equal, "
            f"{sum(len(row['flips']) for row in r['rows'])} flips; cuda vs "
            "cpu after each " + ", ".join(f"{d:.3g}" for d in diffs)
            + " (cuda vs cuda' " + ", ".join(
                f"{row['card_vs_card_']:.3g}" for row in r["rows"]) + ")")


def identity_phase() -> str:
    """tests/test_rl_learning.py's identity learning test on the card."""
    env = make_discrete_identity_env(16, dim=4, device=DEV)
    init_fn, train_step, _ = ppo.make_ppo(
        env, network="mlp", nsteps=16, nminibatches=2, noptepochs=2,
        lr=1e-2, cliprange=0.2, total_updates=60,
        network_kwargs=dict(num_hidden=32), device=DEV)
    state = init_fn(0)
    for _ in range(60):
        state, metrics = train_step(state)
    r = float(metrics["mean_reward"])
    check(r > 0.8, f"ppo failed to learn the identity task: {r}")
    return f"mlp, 16 envs, 60 updates: mean reward {r:.3f} (> 0.8)"


def cli_phase() -> str:
    """``python -m toybox_tpu_torch.run --alg=ppo`` at CLI_ENVS envs for
    CLI_UPDATES updates, saving the policy; the file reads back through
    the port's reader with the trained params."""
    shutil.rmtree(SCRATCH, ignore_errors=True)
    SCRATCH.mkdir(parents=True)
    path = SCRATCH / "breakout.model"
    n = CLI_ENVS
    steps = CLI_UPDATES * n * run.ALG_DEFAULTS["ppo"]["nsteps"] * 4
    state = run.main(["--alg=ppo", "--env=BreakoutToyboxNoFrameskip-v4",
                      f"--num_envs={n}", f"--num_timesteps={steps}",
                      f"--save_path={path}", f"--log_path={SCRATCH / 'log'}",
                      f"--device={DEV}"])
    check(state.update == CLI_UPDATES,
          f"the CLI trained {state.update} updates")
    module = build_policy((84, 84, 4), state.module.pi.out_features, "cnn",
                          device="cpu")[0]
    ppo.load_params(path, module)
    for k, v in state.module.state_dict().items():
        check(torch.equal(module.state_dict()[k], v.cpu()),
              f"the saved policy differs in {k}")
    rows = (SCRATCH / "log" / "progress.csv").read_text().splitlines()
    check(len(rows) == CLI_UPDATES + 1,
          f"progress.csv has {len(rows)} lines")
    return (f"run.main --alg=ppo --num_envs={n} --num_timesteps={steps}: "
            f"{state.update} updates, {path.stat().st_size} B saved and read "
            f"back equal; progress.csv {len(rows) - 1} rows")


def _kernels_exact(g: Game, cfg, consts, tables, s1, s2,
                   where: str) -> None:
    """The single kernel on s1, the fused one on (s1, s2) and its warp form
    with `tables` exactly equal to their plain versions."""
    p1, p2 = g.prep(cfg, s1), g.prep(cfg, s2)
    pair = torch.stack([p1, p2], 1)
    for name, prep, tab in ((g.kernel, p1[:, None], None),
                            (g.kernel + "_fused", pair, None),
                            (g.kernel + "_fused_warp", pair, tables)):
        got = g.ops.render_frames(prep, consts, tab)
        want = (g.ops.frame_plain(prep, consts) if tab is None
                else g.ops.frame_warp_plain(prep, consts, tab))
        diff = int((got.int() - want.int()).abs().max())
        check(diff == 0, f"{name} differs from its plain version by {diff} "
                         f"{where}")


def behavior_phase(g: Game, state_dict):
    """The gate path of the intervention API. Each scenario's set-up is
    captured on the card and on the cpu (equal JSON); N envs start from it
    by reset_to and play at random, and the single and fused kernels and
    the warp form are held exactly to their plain versions on those states
    at the start and after BEHAVIOR_FRAMES frames. Then run_all_gated with the committed
    ppo model, cut in depth, the launch counts set to 0 just before and
    read just after. Returns (launches, detail)."""
    r = np.random.default_rng(9)
    tables = obs.warp_tables(g.module.HEIGHT, g.module.WIDTH, WARP, DEV)
    checked = []
    for cls in get_scenarios(g.name):
        setup = capture_setup(cls(seed=0), device=DEV)
        check(setup == capture_setup(cls(seed=0), device="cpu"),
              f"{g.name} {cls.__name__}: the set-up captured on the card "
              "differs from the cpu's")
        cfg_js, st_js = setup
        cfg = g.module.config_from_json(cfg_js, DEV)
        consts = g.consts(cfg)
        tree = g.module.state_from_json(cfg, st_js)
        for n in BEHAVIOR_ENVS:
            env = make_batched_env(g.name, n, config=cfg, obs_mode="none",
                                   fast_auto_reset=True, device=DEV)
            st, _ = env.reset_to(tree, torch.arange(n, device=DEV) + 1)
            start = st.game
            for i in range(BEHAVIOR_FRAMES):
                prev = st.game
                a = torch.as_tensor(r.integers(0, env.num_actions, n),
                                    device=DEV)
                st = env.step(st, a)[0]
                if i == 0:
                    _kernels_exact(g, cfg, consts, tables, start, st.game,
                                   f"at the start of {cls.__name__}, N={n}")
            _kernels_exact(g, cfg, consts, tables, prev, st.game,
                           f"after {BEHAVIOR_FRAMES} frames of "
                           f"{cls.__name__}, N={n}")
        torch.cuda.synchronize()
        checked.append(cls.__name__)

    _reset_launches()
    t0 = time.perf_counter()
    results = run_all_gated(g.name, state_dict=state_dict,
                            episodes=GATE_EPISODES,
                            max_frames=GATE_MAX_FRAMES,
                            overrides=overrides_for("ppo", g.name),
                            device=DEV)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(render_cuda.LAUNCHES)
    mine = {k: launches[k] for k in (g.kernel, g.kernel + "_fused")}
    check(all(v > 0 for v in mine.values()),
          f"a {g.name} frame kernel did not launch in the gate: {launches}")
    lines = []
    for name, res in results.items():
        for key in ("scores", "control"):
            vals = res[key] or []
            check(all(math.isfinite(v) for v in vals),
                  f"{g.name} {name} {key} not finite: {vals}")
        status = ("WAIVED" if res["passed"] is None
                  else "PASS" if res["passed"] else "FAIL")
        lines.append(f"{name} {status} scores {res['scores']} control "
                     f"{res['control']} ({res['seconds']:.1f} s)")
    detail = (f"{g.name}: kernels exact on the reset_to states of "
              f"{', '.join(checked)} at N={BEHAVIOR_ENVS}; gate "
              f"{GATE_EPISODES} episodes x <= {GATE_MAX_FRAMES} frames "
              f"in {dt:.1f} s: " + "; ".join(lines)
              + f"; launches {launches}")
    return mine, detail


def _max_diff(got, want) -> tuple:
    """(max |got - want|, max |want|) over tensors or tuples of them."""
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    return err, max(float(w.abs().max()) for w in want)


def head_phase(path: Path, game: Game):
    """One checkpoint: its head on the card against the cpu's on one
    batch (recurrent: HEADS_T steps, envs done at t = HEADS_DONE_AT), then
    one serve chunk with the launch counts set to 0 just before and read
    just after. Returns (launches, detail)."""
    alg, network = checkpoint_head(path.name)
    sd = load_state_dict(path)
    heads = {}
    for d in (DEV, "cpu"):
        heads[d] = eval_head(alg, network, game.name, device=d)[0]
        heads[d].load_state_dict(sd)
    r = np.random.default_rng(0)
    recurrent = network in RECURRENT_NETWORKS
    steps = HEADS_T if recurrent else 1
    err, scale = 0.0, 0.0
    carry = {d: heads[d].initial_carry(HEADS_N) for d in heads} \
        if recurrent else {}
    for t in range(steps):
        obs = torch.as_tensor(r.integers(0, 256, (HEADS_N, 84, 84, 4),
                                         dtype=np.uint8))
        out = {}
        with torch.no_grad():
            for d, m in heads.items():
                if recurrent:
                    done_t = ((torch.arange(HEADS_N) % 2 == 0)
                              & (t == HEADS_DONE_AT))
                    out[d] = m(obs.to(d), carry[d], done_t.to(d))
                    carry[d] = out[d][2]
                    out[d] = out[d][:2] + tuple(carry[d])
                else:
                    out[d] = m(obs.to(d))
        e, sc = _max_diff(out[DEV], out["cpu"])
        err, scale = max(err, e), max(scale, sc)
    tol = HEADS_ATOL * max(1.0, scale)
    check(err <= tol, f"{path.name}: the head on the card differs from the "
                      f"cpu's by {err} (tolerance {tol})")
    _reset_launches()
    t0 = time.perf_counter()
    scores = play_games(game.name, sd, network, HEADS_GAMES, alg=alg,
                        chunk=HEADS_STEPS, device=DEV,
                        max_frames=4 * HEADS_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(render_cuda.LAUNCHES)
    mine = {k: launches[k] for k in (game.kernel, game.kernel + "_fused")}
    check(all(v > 0 for v in mine.values()),
          f"a {game.name} frame kernel did not launch in {path.name}'s "
          f"serve chunk: {launches}")
    check(np.isfinite(scores).all(), f"{path.name} scored {scores}")
    detail = (f"{path.name} ({alg}/{network}): card vs cpu max diff "
              f"{err:.2e} (outputs up to {scale:.3g}, tolerance {tol:.2e}"
              f"{f', {steps} steps' if recurrent else ''}); serve chunk "
              f"{HEADS_GAMES} x {HEADS_STEPS} agent steps in {dt:.2f} s, "
              f"mean raw score so far {float(scores.mean()):.2f}, launches "
              + ", ".join(f"{k} {v}" for k, v in mine.items()))
    return mine, detail


def adapter_phase(path: Path, game: Game) -> str:
    """``make_tb_policy`` on the card's facade and on the cpu's, the same
    action script: equal frame counts, stacks within 1 grey level, and the
    single-frame kernel launched on the card."""
    from toybox_tpu_torch import Toybox

    alg, network = checkpoint_head(path.name)
    sd = load_state_dict(path)
    fns = {d: make_tb_policy(alg, network, sd, game.name, device=d)
           for d in (DEV, "cpu")}
    tbs = {d: Toybox(game.name, seed=0, device=d) for d in fns}
    script = np.random.default_rng(4).choice(
        np.asarray(game.module.LEGAL_ACTIONS), ADAPTER_FRAMES)
    _reset_launches()
    worst = 0
    for i, a in enumerate(script):
        for d, fn in fns.items():
            fn(tbs[d])
            tbs[d].apply_ale_action(int(a))
        if i % 4 == 0:
            worst = max(worst, int((fns[DEV].state["stack"].cpu().int()
                                    - fns["cpu"].state["stack"].int())
                                   .abs().max()))
    single = render_cuda.LAUNCHES[game.kernel]
    check(worst <= 1, f"{path.name} adapter stacks differ by {worst}")
    check(single > 0, f"the {game.kernel} kernel did not launch in the "
                      "adapter")
    check(tbs[DEV].to_state_json() == tbs["cpu"].to_state_json(),
          f"{game.name} facade states differ between the card and the cpu")
    return (f"adapter {path.name}: {ADAPTER_FRAMES} frames, stacks max diff "
            f"{worst}, {single} single-frame launches")


# ---------------------------------------------------------------------------
# The env layer's other paths: Gridworld, the obs modes, the state tools and
# the gym surface. None launches a frame kernel: Gridworld and the obs modes
# render with the engines' plain ``render`` (as the JAX package renders them
# with ``render``, not with a Pallas kernel).
# ---------------------------------------------------------------------------

def _ending_start(name: str, st, d):
    """Every 4th env ends on its first step (Gridworld: one step left of
    the goal, given RIGHT; the others: no lives left), so auto-resets run
    inside a short window."""
    game = st.game
    n = game.lives.shape[0]
    first = (torch.arange(n, device=d) % 4 == 0)
    if name == "gridworld":
        left_of_goal = torch.tensor([6, 5], dtype=torch.int32, device=d)
        game = game.replace(player=torch.where(first[:, None], left_of_goal,
                                               game.player))
    else:
        game = game.replace(lives=torch.where(
            first, torch.zeros_like(game.lives), game.lives))
    return dataclasses.replace(st, game=game)


def _ending_actions(name: str, n_act: int, steps: int, n: int, seed: int):
    r = np.random.default_rng(seed)
    acts = r.integers(0, n_act, size=(steps, n))
    if name == "gridworld":
        acts[0, ::4] = 2                    # RIGHT (legal index 2)
    return acts


def gridworld_engine_phase() -> str:
    """The Gridworld engine in the batched env on cuda and on cpu from the
    same seeds and actions: every state tensor bit-equal."""
    n, steps = GRID_ENVS, GRID_ENGINE_STEPS
    envs = {d: make_batched_env("gridworld", n, obs_mode="none", device=d)
            for d in (DEV, "cpu")}
    states = {d: _ending_start("gridworld", env.reset(torch.arange(
        n, device=d) + 100)[0], d) for d, env in envs.items()}
    n_done = 0
    for i, a in enumerate(_ending_actions("gridworld", 5, steps, n, 11)):
        out = {}
        for d, env in envs.items():
            states[d], _, rew, done, _ = env.step(
                states[d], torch.as_tensor(a, device=d))
            out[d] = (rew, done)
        if i % 10 == 9 or i == steps - 1:
            for f in gw.FIELDS:
                c, h = (getattr(states[d].game, f).cpu() for d in
                        (DEV, "cpu"))
                check(torch.equal(c, h), f"gridworld engine field {f} "
                                         f"differs at step {i}")
            check(torch.equal(states[DEV].seeds.cpu(), states["cpu"].seeds),
                  "gridworld reseeds differ")
        for k in (0, 1):
            check(torch.equal(out[DEV][k].cpu(), out["cpu"][k]),
                  f"gridworld reward/done differ at step {i}")
        n_done += int(out["cpu"][1].sum())
    check(n_done > 0, "no gridworld game ended")
    return (f"engine {n} envs x {steps} steps bit-equal; {n_done} game "
            f"overs, score {int(states['cpu'].game.score.sum())}")


def gridworld_pipeline_phase() -> str:
    """make_rl_env("gridworld") on cuda and on cpu (the max of two plain
    grey frames, then the matmul warp): rewards, dones and lives equal,
    observations within 1 grey level."""
    n, steps = GRID_ENVS, GRID_PIPE_STEPS
    envs = {d: make_rl_env("gridworld", n, device=d) for d in (DEV, "cpu")}
    states = {}
    for d, env in envs.items():
        st, _ = env.reset(torch.arange(n, device=d))
        states[d] = dataclasses.replace(
            st, env=_ending_start("gridworld", st.env, d))
    worst, dones, reward = 0, 0, 0.0
    for i, a in enumerate(_ending_actions("gridworld", 5, steps, n, 12)):
        out = {}
        for d, env in envs.items():
            states[d], o, rew, done, info = env.step(
                states[d], torch.as_tensor(a, device=d))
            out[d] = (o, rew, done, info["lives"])
        for k in (1, 2, 3):
            check(torch.equal(out[DEV][k].cpu(), out["cpu"][k]),
                  f"gridworld pipeline reward/done/lives differ at step {i}")
        worst = max(worst, int((out[DEV][0].cpu().int()
                                - out["cpu"][0].int()).abs().max()))
        dones += int(out["cpu"][2].sum())
        reward += float(out["cpu"][1].sum())
    check(worst <= 1, f"gridworld pipeline obs differ by {worst}")
    check(dones > 0, "no gridworld episode ended in the pipeline")
    return (f"pipeline {n} envs x {steps} steps: reward/done/lives equal "
            f"({dones} dones, reward {reward}), obs max diff {worst}")


def gridworld_cli_phase() -> str:
    """``run.main --alg=ppo --env=GridWorldToyboxNoFrameskip-v4`` at
    GRID_ENVS envs, two updates of GRID_NSTEPS steps: finite losses, the
    policy saved and read back equal."""
    path = SCRATCH / "gridworld.model"
    log = SCRATCH / "gridworld_log"
    n = GRID_ENVS
    state = run.main(["--alg=ppo", "--env=GridWorldToyboxNoFrameskip-v4",
                      f"--num_envs={n}",
                      f"--num_timesteps={2 * n * GRID_NSTEPS * 4}",
                      f"--nsteps={GRID_NSTEPS}", f"--save_path={path}",
                      f"--log_path={log}", f"--device={DEV}"])
    check(state.update == 2, f"gridworld CLI trained {state.update} updates")
    module = build_policy((84, 84, 4), 5, "cnn", device="cpu")[0]
    ppo.load_params(path, module)
    for k, v in state.module.state_dict().items():
        check(torch.equal(module.state_dict()[k], v.cpu()),
              f"the saved gridworld policy differs in {k}")
    with open(log / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 2, f"progress.csv has {len(rows)} rows")
    losses = {k: float(rows[-1][f"loss/{k}"]) for k in ppo.METRICS}
    check(all(math.isfinite(v) for v in losses.values()),
          f"gridworld losses {losses}")
    return (f"run.main gridworld {n} envs x nsteps {GRID_NSTEPS}: 2 updates, "
            f"fps {rows[-1]['fps']}, last losses " + ", ".join(
                f"{k} {v:.4g}" for k, v in losses.items())
            + f"; {path.stat().st_size} B saved and read back equal")


def gridworld_profile_phase() -> str:
    """The Gridworld pipeline with a random cnn policy at GRID_ENVS envs:
    ms per agent step and the device-busy share (phase 7's window)."""
    env = make_rl_env("gridworld", GRID_ENVS, device=DEV)
    _, p_step = build_eval_policy("ppo", env.obs_shape, env.num_actions,
                                  "cnn", device=DEV)
    return _profile_window("gridworld", env, p_step, GRID_ENVS,
                           PROFILE_STEPS)


def _obs_rollout(env, name, d, acts):
    st, obs0 = env.reset(torch.arange(env.num_envs, device=d) + 3)
    st = _ending_start(name, st, d)
    out = [obs0]
    for a in acts:
        st, obs, rew, done, _ = env.step(st, torch.as_tensor(a, device=d))
        out.append((obs, rew, done))
    return out


def _mode_of_rgba(mode: str, rgba: torch.Tensor) -> torch.Tensor:
    """A mode's obs from the rgba frames, as the batched env defines it."""
    if mode == "grayscale":
        return luma2d(rgba)[..., None]
    return rgba if mode == "rgba" else rgba[..., :3]


def obs_modes_phase(name: str) -> str:
    """make_batched_env(obs_mode=m) for m in OBS_MODES, auto_reset on and
    off: at OBS_EXACT_ENVS envs x OBS_EXACT_STEPS steps obs, rewards and
    dones
    exactly equal to the cpu's (the cpu side renders rgba once and takes
    each mode from it); BatchedEnv equal to the functional env; each mode
    timed at OBS_TIME_ENVS envs on cuda (ms a step, peak memory), beside
    obs_mode="none". For a frame-kernel game, the pipeline then steps on
    cuda with the engine's render refused: its inner env renders
    nothing."""
    module = get_game(name)
    n, steps = OBS_EXACT_ENVS, OBS_EXACT_STEPS
    acts = _ending_actions(name, len(module.LEGAL_ACTIONS), steps, n, 13)
    dones = 0
    for auto in (True, False):
        ref = _obs_rollout(make_batched_env(
            name, n, obs_mode="rgba", auto_reset=auto, device="cpu"),
            name, "cpu", acts)
        for mode in OBS_MODES:
            got = _obs_rollout(make_batched_env(
                name, n, obs_mode=mode, auto_reset=auto, device=DEV),
                name, DEV, acts)
            check(torch.equal(got[0].cpu(), _mode_of_rgba(mode, ref[0])),
                  f"{name} {mode} reset obs differ from the cpu's")
            for i, (g, c) in enumerate(zip(got[1:], ref[1:])):
                check(torch.equal(g[0].cpu(), _mode_of_rgba(mode, c[0])),
                      f"{name} {mode} auto_reset={auto} obs differ at {i}")
                for k in (1, 2):
                    check(torch.equal(g[k].cpu(), c[k]),
                          f"{name} {mode} auto_reset={auto} reward/done "
                          f"differ at step {i}")
        dones += sum(int(c[2].sum()) for c in ref[1:])
    check(dones > 0, f"no {name} game ended in the obs-mode runs")
    fns = make_batched_env(name, n, device=DEV)
    benv = BatchedEnv(name, n, seed=3, device=DEV)
    st, obs = fns.reset(torch.arange(n, device=DEV) + 3)
    check(torch.equal(benv.reset(), obs), f"{name} BatchedEnv reset differs")
    for a in acts[:10]:
        a = torch.as_tensor(a, device=DEV)
        st, obs, rew, done, _ = fns.step(st, a)
        bobs, brew, bdone, _ = benv.step(a)
        check(torch.equal(bobs, obs) and torch.equal(brew, rew)
              and torch.equal(bdone, done), f"{name} BatchedEnv differs")
    times = []
    for mode in ("none",) + OBS_MODES:
        env = make_batched_env(name, OBS_TIME_ENVS, obs_mode=mode,
                               device=DEV)
        st, _ = env.reset(torch.arange(OBS_TIME_ENVS, device=DEV))
        a = torch.ones(OBS_TIME_ENVS, dtype=torch.long, device=DEV)
        for _ in range(2):
            st, *_ = env.step(st, a)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        for _ in range(OBS_STEPS):
            st, obs, *_ = env.step(st, a)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / OBS_STEPS
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        times.append(f"{mode} {ms:.2f} ms/step (peak +{peak:.0f} MiB)")
        del st, obs, env
    detail = (f"{name}: exact at {n} envs x {steps} steps on "
              f"{'/'.join(OBS_MODES)} x auto_reset on/off ({dones} dones), "
              f"BatchedEnv equal; at {OBS_TIME_ENVS} envs: "
              + ", ".join(times))
    if name in FRAME_KERNEL_GAMES:
        calls = []
        orig = module.render
        module.render = lambda *args: calls.append(1) or orig(*args)
        try:
            env = make_rl_env(name, PIPELINE_ENVS, device=DEV)
            st, _ = env.reset(torch.arange(PIPELINE_ENVS, device=DEV))
            for _ in range(5):
                st, *_ = env.step(st, torch.ones(PIPELINE_ENVS,
                                                 dtype=torch.long,
                                                 device=DEV))
        finally:
            module.render = orig
        check(not calls, f"the {name} pipeline called render {len(calls)} "
                         "times")
        detail += "; the pipeline's inner env renders nothing"
    return detail


def state_tools_phase() -> str:
    """fit_models on a STATE_FRAMES-state Breakout trajectory played on the
    card's facade, sample_state and write_state_json (the sampled state
    loads and steps, its JSON equal to the cpu facade's load); each
    committed seed-state fixture's predicate after load on cuda; then
    extract_seed_state with the committed ppo1 model for life_lost,
    capped at SEED_STATE_FRAMES frames, at the seeds in turn until one
    returns a state (the trained agent may keep its lives longer than the
    cap): the predicate holds on the state it returns."""
    tb = Toybox("breakout", device=DEV)
    tb.apply_ale_action(1)
    states = []
    for i in range(STATE_FRAMES):
        for _ in range(5):
            tb.apply_ale_action(3 if i % 2 else 4)
        states.append(tb.to_state_json())
    models = fit_models(states)
    for queries in (("paddle.position.x",), ()):     # one field, then all
        new = sample_state(models, states[0], *queries,
                           rng=np.random.default_rng(0))
        loaded = {}
        for d in (DEV, "cpu"):
            t = Toybox("breakout", device=d)
            t.write_state_json(new)
            loaded[d] = t.to_state_json()
            t.apply_ale_action(0)
        check(loaded[DEV] == loaded["cpu"], "a sampled state loads "
                                            "differently on the card")
    check(sample_state(models, states[0], "paddle.position.x",
                       rng=np.random.default_rng(0))["lives"]
          == states[0]["lives"], "sampling one field changed another")
    for path in sorted(FIXTURES.glob("breakout_*_seed0.json")):
        pred = path.name[len("breakout_"):-len("_seed0.json")]
        t = Toybox("breakout", withstate=json.loads(path.read_text()),
                   device=DEV)
        check(PREDICATES[pred](t), f"{pred} does not hold after loading "
                                   f"{path.name} on the card")
    weights = load_state_dict(MODELS / "Breakout.ppo1.model")
    tries = []
    for seed in SEED_STATE_SEEDS:
        policy = make_tb_policy("ppo1", "cnn", weights, "breakout",
                                seed=seed, device=DEV)
        t1 = time.perf_counter()
        state, frame = extract_seed_state(
            "breakout", "life_lost", max_frames=SEED_STATE_FRAMES,
            seed=seed, policy=policy, device=DEV)
        dt = time.perf_counter() - t1
        played = frame + 1 if state is not None else SEED_STATE_FRAMES
        tries.append(f"seed {seed}: " + (
            f"frame {frame}" if state is not None else "never held")
            + f" in {dt:.1f} s ({dt * 1e3 / played:.2f} ms/frame)")
        if state is not None:
            break
    check(state is not None, "life_lost never held in "
                             f"{SEED_STATE_FRAMES} frames at seeds "
                             f"{SEED_STATE_SEEDS}")
    check(PREDICATES["life_lost"](Toybox("breakout", withstate=state,
                                         device=DEV)),
          "life_lost does not hold on the extracted state")
    return (f"{len(models)} models from {STATE_FRAMES} states, a sampled "
            f"state equal on load; fixtures hold; ppo1 life_lost, at most "
            f"{SEED_STATE_FRAMES} frames a seed: " + "; ".join(tries))


def gym_phase() -> str:
    """The gymnasium surface on the card: gym.make of the four namespaced
    ids, wrap_deepmind(make_atari(...)) GYM_STEPS steps, and
    make_vec_env(use_batched=True) at OBS_TIME_ENVS envs x OBS_STEPS
    steps."""
    import gymnasium

    from toybox_tpu_torch.envs import GAME_CLASSES, SUFFIX, gym_id
    from toybox_tpu_torch.envs.vec_env import make_vec_env
    from toybox_tpu_torch.envs.wrappers import make_atari, wrap_deepmind

    for game in GAME_CLASSES:
        env = gymnasium.make(gym_id(game + SUFFIX), device=DEV)
        obs, _ = env.reset(seed=0)
        for _ in range(5):
            obs, *_ = env.step(0)
        check(obs.shape == env.observation_space.shape,
              f"{game} obs {obs.shape}")
        env.close()
    env = wrap_deepmind(make_atari("BreakoutToyboxNoFrameskip-v4",
                                   device=DEV), frame_stack=True)
    env.reset(seed=0)
    for i in range(GYM_STEPS):
        obs, _, term, trunc, _ = env.step(i % 4)
        if term or trunc:
            env.reset()
    check(np.asarray(obs).shape == (84, 84, 4), "deepmind stack shape")
    venv = make_vec_env("BreakoutToyboxNoFrameskip-v4", OBS_TIME_ENVS,
                        seed=0, device=DEV)
    venv.reset()
    t1 = time.perf_counter()
    for _ in range(OBS_STEPS):
        obs, *_ = venv.step(np.ones(OBS_TIME_ENVS, np.int64))
    ms = (time.perf_counter() - t1) * 1e3 / OBS_STEPS
    return (f"4 namespaced ids made and stepped; wrap_deepmind {GYM_STEPS} "
            f"steps; make_vec_env {OBS_TIME_ENVS} envs {ms:.2f} ms/step")


# ---------------------------------------------------------------------------
# 18. The on-policy learners after PPO: a2c (and recurrent a2c), recurrent
# PPO and ACKTR with K-FAC, through run.main at the published widths.
# ---------------------------------------------------------------------------

#: (label, game, run.main arguments, updates (or cycles), agent steps an
#: update, eval head (alg, network), the logged metrics to check); each
#: run's env is the pipeline's in-kernel warp
PG_KEYS = ("policy_loss", "value_loss", "policy_entropy")
LEARNERS = (
    ("a2c cnn", "breakout",
     ["--alg=a2c", "--num_envs=32", "--updates_per_jit=16",
      "--log_interval=16"], 16, 5, ("a2c", "cnn"), PG_KEYS),
    ("a2c cnn_lstm", "breakout",
     ["--alg=a2c", "--network=cnn_lstm", "--num_envs=32",
      "--updates_per_jit=4", "--log_interval=4"], 4, 5,
     ("a2c", "cnn_lstm"), PG_KEYS),
    ("ppo cnn_lstm", "breakout",
     ["--alg=ppo", "--network=cnn_lstm", "--num_envs=1024"], 1, 128,
     ("ppo", "cnn_lstm"), PG_KEYS),
    ("ppo cnn_lnlstm", "space_invaders",
     ["--alg=ppo", "--network=cnn_lnlstm", "--num_envs=1024",
      "--nsteps=32"], 1, 32, ("ppo", "cnn_lnlstm"), PG_KEYS),
    ("acktr", "breakout",
     ["--alg=acktr", "--num_envs=32", "--updates_per_jit=2",
      "--log_interval=2", "--invert_every=16", "--kfac_clip=0.01"], 2, 20,
     ("acktr", "cnn"), PG_KEYS),
)
#: phase 19: the replay learners and TRPO at their recipes
#: (docs/TRAINING.md), cut in depth: deepq one block of 64 cycles with
#: learning_starts 64 (SGD from cycle 5; a target sync at 1 000 env
#: steps), acer 2 blocks of 2 cycles (replay from the second cycle),
#: acer cnn_lstm one block of 2, trpo one update
REPLAY_LEARNERS = (
    ("deepq", "space_invaders",
     ["--alg=deepq", "--num_envs=8", "--train_freq=2", "--batch_size=64",
      "--jit_cycles=64", "--log_interval=1", "--learning_starts=64"],
     64, 2, ("deepq", "conv_only"), ("loss", "mean_q", "epsilon")),
    ("acer cnn_small", "breakout",
     ["--alg=acer", "--num_envs=16", "--cycles_per_jit=2",
      "--log_interval=2"], 4, 20, ("acer", "cnn_small"),
     ("pg_loss", "q_loss", "entropy")),
    ("acer cnn_lstm", "space_invaders",
     ["--alg=acer", "--network=cnn_lstm", "--num_envs=16",
      "--cycles_per_jit=2", "--log_interval=2"], 2, 20,
     ("acer", "cnn_lstm"), ("pg_loss", "q_loss", "entropy")),
    ("trpo", "space_invaders", ["--alg=trpo", "--num_envs=16"], 1, 512,
     ("trpo", "cnn_small"), ("surrogate_gain", "kl", "vf_loss", "entropy")),
)
#: each recipe's frames (docs/TRAINING.md: the Breakout rows, and the
#: game each phase-19 run plays)
RECIPE_FRAMES = {"a2c cnn": 60e6, "a2c cnn_lstm": 120e6,
                 "ppo cnn_lstm": 120e6, "ppo cnn_lnlstm": 120e6,
                 "acktr": 640e6, "deepq": 40e6, "acer cnn_small": 320e6,
                 "acer cnn_lstm": 160e6, "trpo": 40e6}
LEARNER_PROFILE_ENVS = 32        # collect is profiled up to this width
LEARNER_PROFILE_STEPS = 20       # and this many agent steps
LEARNER_CHECK_ENVS = 8           # the cuda-against-cpu updates
A2C_ATOL, A2C_LSTM_ATOL, PPO_LSTM_ATOL, ACKTR_ATOL = 1e-5, 1e-5, 1e-5, 1e-6
# phase 19: DQN one Adam step (lr 1e-4), ACER 1 + 4 RMSProp steps (as
# a2c's), TRPO relative to its step's largest move (ten CG iterations on
# double-backward Fisher-vector products: cuDNN and the CPU sum in other
# orders; tests/test_torch_trpo.py)
DQN_ATOL, ACER_ATOL, TRPO_RTOL = 1e-6, 1e-5, 1e-4


class _TimedSteps:
    """Times every train_step of the learners (all are ppo.TrainStep:
    ``collect``, then ``optimize``) on the host clock, each half to a
    sync, records each half's peak device memory, and keeps the last
    step's TrainStep, state and batch."""

    def __enter__(self):
        self.rows, self.peaks, self.last = [], [], None
        self.call = ppo.TrainStep.__call__
        rows = self

        def timed(step, state):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            collected = step.collect(state)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = step.optimize(state, collected)
            torch.cuda.synchronize()
            rows.rows.append((t1 - t0, time.perf_counter() - t1))
            rows.peaks.append((peak, torch.cuda.max_memory_allocated()))
            rows.last = (step, state, collected)
            return out

        ppo.TrainStep.__call__ = timed
        return self

    def __exit__(self, *exc):
        ppo.TrainStep.__call__ = self.call


def _busy(fn, label: str) -> str:
    """``label``'s device kernels and busy share over fn() to a sync under
    torch.profiler, tracing the device only (the host's op records of a
    100 000-kernel window take the profiler tens of seconds to read)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e6
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ks:
        return f"{label}: device time not measured (no CUDA records)"
    busy = sum(e.time_range.elapsed_us() for e in ks)
    return (f"{label} {len(ks)} kernels, busy {busy:.0f} of {wall:.0f} us "
            f"({100 * busy / wall:.1f}%)")


def learner_run(label, game, args, updates, nsteps, head, keys,
                extra_steps=0):
    """A main path: run.main trains ``updates`` updates (or cycles) and
    saves the policy, the launch counts set to 0 just before and read just
    after (the warp kernel once an agent step: updates x nsteps, and
    ``extra_steps`` more outside the updates); each update's collect and
    optimize timed apart; the last logged row's ``keys`` finite. Then the
    saved file through ``load_eval_params`` (equal params), and one more
    collect (at most LEARNER_PROFILE_ENVS envs x LEARNER_PROFILE_STEPS
    steps) and optimize under the profiler. Returns (launches, detail,
    state)."""
    from toybox_tpu_torch.rl.eval_adapter import load_eval_params

    g = next(x for x in GAMES if x.name == game)
    path = SCRATCH / f"{label.replace(' ', '_')}.model"
    log_dir = SCRATCH / label.replace(" ", "_")
    env_id = {"breakout": "Breakout", "space_invaders": "SpaceInvaders",
              "amidar": "Amidar"}[game] + "ToyboxNoFrameskip-v4"
    n_envs = int(next(a for a in args if a.startswith("--num_envs="))
                 .split("=")[1])
    frames = updates * n_envs * nsteps * 4
    _reset_launches()
    with _TimedSteps() as timed:
        state = run.main(args + [
            f"--env={env_id}", f"--num_timesteps={frames}",
            f"--save_path={path}", f"--log_path={log_dir}",
            f"--device={DEV}"])
        torch.cuda.synchronize()
    launches = dict(render_cuda.LAUNCHES)
    warp, single = g.kernel + "_fused_warp", g.kernel
    check(state.update == updates == len(timed.rows),
          f"{label} trained {state.update} updates, timed {len(timed.rows)}")
    check(launches[warp] == updates * nsteps + extra_steps,
          f"{label}: {warp} launched {launches[warp]} times in {updates} "
          f"updates of {nsteps} steps and {extra_steps} more: {launches}")
    check(launches[single] > 0, f"{label}: {single} never launched")
    rows = list(csv.DictReader(
        (log_dir / "progress.csv").read_text().splitlines()))
    check(len(rows) >= 1, f"{label} logged no row")
    for k in keys:
        check(math.isfinite(float(rows[-1][k])), f"{label} {k} = "
                                                  f"{rows[-1][k]}")
    module = load_eval_params(*head, path, game, device=DEV)
    for k, v in state.module.state_dict().items():
        check(torch.equal(module.state_dict()[k], v),
              f"{label}: the saved file differs in {k}")
    steady = timed.rows[1:] or timed.rows
    collect = sum(r[0] for r in steady) / len(steady)
    optimize = sum(r[1] for r in steady) / len(steady)
    per_update = collect + optimize
    first = ("" if len(timed.rows) == 1 else "; the first: collect "
             f"{1e3 * timed.rows[0][0]:.1f}, optimize "
             f"{1e3 * timed.rows[0][1]:.1f}")
    nbatch = n_envs * nsteps
    step, st, collected = timed.last
    shares = []
    if n_envs <= LEARNER_PROFILE_ENVS and nsteps <= LEARNER_PROFILE_STEPS:
        out = []
        shares.append(_busy(lambda: out.append(step.collect(st)), "collect"))
        collected = out[0]
    else:
        shares.append(f"collect ({n_envs} envs x {nsteps} steps) not "
                      "profiled")
    shares.append(_busy(lambda: step.optimize(st, collected), "optimize"))
    fps = nbatch * 4 / per_update
    detail = (f"{label} on {game}, {n_envs} envs x nsteps {nsteps}, "
              f"{updates} updates: ms an update {1e3 * per_update:.1f} "
              f"(collect {1e3 * collect:.1f}, optimize {1e3 * optimize:.1f};"
              f" over {len(steady)} updates{first}), {fps:.0f} frames/s, the "
              f"recipe's {RECIPE_FRAMES[label]:.0f} frames in "
              f"{RECIPE_FRAMES[label] / fps / 3600:.2f} h; {'; '.join(shares)}"
              f"; launches {single} {launches[single]}, {warp} "
              f"{launches[warp]} "
              f"({(launches[warp] - extra_steps) / updates:.0f} an update"
              f"{f', {extra_steps} outside' if extra_steps else ''}); "
              f"last row " + ", ".join(
                  f"{k} {float(rows[-1][k]):.4g}" for k in
                  keys + (("eprewmean",) if "eprewmean" in rows[-1] else ()))
              + f"; {path.stat().st_size} B saved, read back equal")
    return launches, detail, state


def _cpu_batch(make, **kw):
    """(train_step, state, collected) of a learner on LEARNER_CHECK_ENVS
    Breakout envs on the cpu: one collect."""
    env = make_rl_env("breakout", LEARNER_CHECK_ENVS, device="cpu")
    out = make(env, device="cpu", **kw)
    state = out[0](0)
    return out[1], state, out[1].collect(state)


def _diff(mods: dict, before: dict) -> tuple:
    after = {d: {k: v.cpu() for k, v in m.state_dict().items()}
             for d, m in mods.items()}
    moved = max(float((after["cpu"][k] - before[k]).abs().max())
                for k in before)
    diff = max(float((after[DEV][k] - after["cpu"][k]).abs().max())
               for k in before)
    return moved, diff


def _check_moved(label: str, mods: dict, before: dict, tol: float,
                 relative: bool = False) -> str:
    """The cuda and cpu modules ``mods`` after one update from ``before``:
    the update moved the params by more than 10 bounds and the two agree
    within the bound (``tol``, or ``tol`` of the move when relative)."""
    moved, diff = _diff(mods, before)
    bound = tol * moved if relative else tol
    check(moved > 10 * bound, f"{label}: the update moved the params by "
                              f"only {moved}")
    check(diff <= bound, f"{label}: cuda and cpu differ by {diff} (bound "
                         f"{bound:.3g})")
    return (f"{label} moved {moved:.3g}, cuda vs cpu {diff:.3g} (tolerance "
            f"{tol:g}{' of the move' if relative else ''})")


def learner_update_phase() -> str:
    """One update of each learner on cuda and on cpu from the same params
    and batch (a cpu collect at LEARNER_CHECK_ENVS envs): params within
    the learner's tolerance."""
    from toybox_tpu_torch.rl import a2c, acktr, ppo_recurrent

    out = []

    def compare(label, mods, before, atol, run_one):
        for d, m in mods.items():
            run_one(d, m)
        out.append(_check_moved(label, mods, before, atol))

    def pair(module, copy):
        before = {k: v.clone() for k, v in module.state_dict().items()}
        copy.load_state_dict(before)
        return {DEV: copy.to(DEV), "cpu": module}, before

    lrnow = ppo.anneal(0, 1, 7e-4, 0.0)[0]
    hp = a2c.Hyper()
    # a2c, cnn
    _, st, (returns, buf) = _cpu_batch(a2c.make_a2c, nsteps=5)
    mods, before = pair(st.module, build_policy(
        (84, 84, 4), 4, "cnn", device="cpu")[0])
    compare("a2c cnn", mods, before, A2C_ATOL, lambda d, m: a2c.update(
        m, ppo.RmsState.zeros_like(list(m.parameters())), buf.obs.to(d),
        buf.actions.to(d), returns.to(d), lrnow, hp, 4))
    # a2c, cnn_lstm
    _, st, ((returns, carry0), buf) = _cpu_batch(
        a2c.make_recurrent_a2c, network="cnn_lstm", nsteps=5)
    mods, before = pair(st.module, ppo_recurrent.build_recurrent_policy(
        (84, 84, 4), 4, "cnn_lstm", 128, "cpu")[0])
    compare("a2c cnn_lstm", mods, before, A2C_LSTM_ATOL,
            lambda d, m: a2c.recurrent_update(
                m, ppo.RmsState.zeros_like(list(m.parameters())),
                buf.obs.to(d), buf.actions.to(d), returns.to(d),
                buf.prev_dones.to(d), tuple(c.to(d) for c in carry0), lrnow,
                hp, 4))
    # recurrent ppo, cnn_lstm: 4 epochs x 4 minibatches of 2 envs
    _, st, (rb, _) = _cpu_batch(ppo_recurrent.make_recurrent_ppo,
                                network="cnn_lstm", nsteps=8)
    mods, before = pair(st.module, ppo_recurrent.build_recurrent_policy(
        (84, 84, 4), 4, "cnn_lstm", 128, "cpu")[0])
    perms = [torch.randperm(LEARNER_CHECK_ENVS, generator=st.generator)
             for _ in range(4)]
    lr_ppo, clip = ppo.anneal(0, 1, 2.5e-4, 0.1)

    def ppo_one(d, m):
        rbd = ppo_recurrent.RecurrentBatch(**{
            f.name: (tuple(c.to(d) for c in getattr(rb, f.name))
                     if f.name == "carry0" else getattr(rb, f.name).to(d))
            for f in dataclasses.fields(rb)})
        ppo_recurrent.update(
            m, ppo.AdamState.zeros_like(list(m.parameters())), rbd,
            [p.to(d) for p in perms], lr_ppo, clip, ppo.Hyper(), 4)

    compare("ppo cnn_lstm", mods, before, PPO_LSTM_ATOL, ppo_one)
    # acktr at the recipe's kfac_clip, one step (it inverts)
    _, st, (returns, buf) = _cpu_batch(acktr.make_acktr, nsteps=20,
                                       kfac_clip=0.01)
    mods, before = pair(st.module, acktr.KfacCNNPolicy(4))
    hpk = acktr.Hyper(kfac_clip=0.01)
    lr_k = ppo.anneal(0, 1, 0.25, 0.0, floor=0.05)[0]
    inv = {}

    def acktr_one(d, m):
        def to(tree):
            return {k: tuple(x.to(d) for x in v) for k, v in tree.items()}
        sd = acktr.ACKTRState(
            module=m, momentum=ppo.MomentumState.zeros_like(
                list(m.parameters())),
            kfac_a={k: v.to(d) for k, v in st.kfac_a.items()},
            perts={k: v.to(d) for k, v in st.perts.items()},
            kfac_stats=to(st.kfac_stats), kfac_inv=to(st.kfac_inv),
            env_state=None, generator=None)
        acktr.kfac_step(sd, buf.obs.reshape((-1, 84, 84, 4)).to(d),
                        buf.actions.reshape(-1).to(d),
                        returns.reshape(-1).to(d), lr_k, hpk, 4)
        inv[d] = sd.kfac_inv["fc0"][1].cpu()

    compare("acktr", mods, before, ACKTR_ATOL, acktr_one)
    sdiff = float((inv[DEV] - inv["cpu"]).abs().max() / inv["cpu"].abs().max())
    out.append(f"acktr fc0 S inverse cuda vs cpu {sdiff:.3g} relative")
    return "; ".join(out)


def kfac_inverse_phase(state) -> str:
    """The damped inverse of fc0's 3 137 x 3 137 A factor (the acktr run's
    EMA), timed alone with CUDA events, beside the other layers'."""
    from toybox_tpu_torch.rl import kfac

    parts = []
    for name, (A, S) in state.kfac_stats.items():
        for what, M in (("A", A), ("S", S)):
            if M.shape[0] < 64 and name != "fc0":
                continue
            ms = cuda_ms(lambda: kfac._damped_inv(M, 0.01), iters=10)
            parts.append(f"{name} {what} {M.shape[0]}: {ms:.3f} ms")
    full = cuda_ms(lambda: kfac.kfac_invert(state.kfac_stats, 0.01), iters=5)
    return ("K-FAC damped inverses (torch.linalg.inv): " + ", ".join(parts)
            + f"; kfac_invert of all layers {full:.3f} ms")


def _ring_to(ring, d):
    """A replay ring (dqn.Replay, acer.TrajReplay) with its tensors on d."""
    return type(ring)(**{k: v.to(d) if torch.is_tensor(v) else v
                         for k, v in ring.state_dict().items()})


def replay_update_phase() -> str:
    """The optimize half of one cycle (or update) of each phase-19 learner
    on cuda and on cpu, from the same params, optimizer moments, ring or
    batch and draws (cpu cycles at LEARNER_CHECK_ENVS Breakout envs make
    them): params within the learner's tolerance."""
    from toybox_tpu_torch.rl import acer, dqn, trpo
    from toybox_tpu_torch.rl.distributions import gumbel
    from toybox_tpu_torch.rl.models import network_factory

    env = make_rl_env("breakout", LEARNER_CHECK_ENVS, device="cpu")
    out = []

    def compare(label, state, copy_to, optimize, tol, relative=False):
        before = {k: v.clone() for k, v in state.module.state_dict().items()}
        states = {DEV: copy_to(DEV), "cpu": state}
        for d, st in states.items():
            optimize(d, st)
        out.append(_check_moved(label, {d: st.module for d, st in
                                        states.items()}, before, tol,
                                relative))

    def load(module, like):
        module.load_state_dict(like.state_dict())
        return module

    # deepq: conv_only, dueling; 3 cycles, then one collect
    init_fn, cycle, _ = dqn.make_dqn(env, buffer_size=256, batch_size=64,
                                     train_freq=2, learning_starts=0,
                                     device="cpu")
    st = init_fn(0)
    for _ in range(3):
        st, _ = cycle(st)
    t_before = cycle.collect(st)
    noise = gumbel((64, 256), torch.Generator().manual_seed(0), "cpu")

    def dqn_copy(d):
        def q():
            return dqn.QNetwork(network_factory("conv_only")((84, 84, 4)),
                                4).to(d)
        return dqn.DQNState(
            module=load(q(), st.module), target=load(q(), st.target),
            adam=ppo.AdamState([x.to(d) for x in st.adam.mu],
                               [x.to(d) for x in st.adam.nu], st.adam.count),
            env_state=None, replay=_ring_to(st.replay, d), generator=None,
            pn_scale=st.pn_scale.to(d), t=st.t, update=st.update)

    compare("deepq", st, dqn_copy, lambda d, s: cycle.optimize(
        s, t_before, {"gumbel": noise.to(d)}), DQN_ATOL)

    # acer: cnn_small; 2 cycles, then a collect: the optimize replays
    init_fn, cycle = acer.make_acer(env, network="cnn_small", nsteps=20,
                                    buffer_traj=4, device="cpu")
    st = init_fn(0)
    for _ in range(2):
        st, _ = cycle(st)
    cur, ep = cycle.collect(st)
    idx = torch.tensor([0, 2, 1, 2])

    def acer_copy(d):
        def pol():
            return acer.build_acer_policy((84, 84, 4), 4, "cnn_small",
                                          device=d)[0]
        return acer.ACERState(
            module=load(pol(), st.module), avg=load(pol(), st.avg),
            rms=ppo.RmsState([x.to(d) for x in st.rms.nu]), env_state=None,
            replay=_ring_to(st.replay, d), generator=None, update=st.update)

    compare("acer", st, acer_copy, lambda d, s: cycle.optimize(
        s, (cur, ep), {"replay_idx": idx.to(d)}), ACER_ATOL)

    # trpo: cnn_small, nsteps 32
    init_fn, step = trpo.make_trpo(env, network="cnn_small", nsteps=32,
                                   device="cpu")
    st = init_fn(0)
    batch, roll = step.collect(st)

    def trpo_copy(d):
        def pol():
            return build_policy((84, 84, 4), 4, "cnn_small", device=d)[0]
        vf = load(pol(), st.vf)
        return trpo.TRPOState(
            module=load(pol(), st.module), vf=vf,
            vf_adam=ppo.AdamState.zeros_like(list(vf.parameters())),
            env_state=None, generator=None)

    compare("trpo", st, trpo_copy, lambda d, s: step.optimize(
        s, (tuple(x.to(d) for x in batch), roll)), TRPO_RTOL, relative=True)
    return "; ".join(out)


#: phase 20: ppo1 and BC + GAIL at their recipes (docs/TRAINING.md), cut
#: in depth: ppo1 on Amidar one update; GAIL on Breakout (the expert
#: Breakout.ppo1.model, NatureCNN) with 4 096 expert transitions at stride
#: 2 (of 32 768 at 16), 2 BC epochs (of 100), nsteps 32 (of 128) and two
#: updates at g_step 2 (the second takes the d-step)
IMITATION_LEARNERS = (
    ("ppo1", "amidar",
     ["--alg=ppo1", "--num_envs=256", "--optim_batchsize=4096"], 1, 256,
     ("ppo1", "cnn"), ("loss_pol_surr", "loss_vf_loss", "loss_ent",
                       "loss_kl")),
    ("gail", "breakout",
     ["--alg=gail", "--num_envs=64", "--network=cnn", "--max_kl=0.001",
      f"--load_path={MODELS / 'Breakout.ppo1.model'}",
      "--n_expert_transitions=4096", "--expert_stride=2", "--bc_epochs=2",
      "--nsteps=32", "--g_step=2", "--log_interval=1"], 2, 32,
     ("gail", "cnn"), ("surrogate_gain", "kl", "vf_loss", "adv_reward",
                       "disc_loss", "disc_acc")),
)
RECIPE_FRAMES.update({"ppo1": 120e6, "gail": 1e6})
#: the BC recipe: 32 768 transitions at stride 16 on 64 envs, 100 epochs of
#: 256 minibatches of 128
BC_RECIPE_STEPS, BC_RECIPE_MINIBATCHES = 32768 // 64 * 16, 100 * 256
#: the JAX learning test's DDPG (tests/test_rl_learning.py:116-130)
DDPG_ENVS, DDPG_CYCLES, DDPG_THRESHOLD = 8, 600, -0.35
DDPG_KW = dict(actor_lr=3e-3, critic_lr=3e-3, batch_size=128,
               buffer_size=8192, noise_scale=0.2, learning_starts=256)
# phase 20, cuda against cpu: ppo1 16 Adam steps (lr 1e-3), as ppo's;
# GAIL-TRPO's policy relative to its step's largest move (as TRPO's);
# DDPG one cycle of two Adam steps. GAIL's value network (3 Adam steps)
# and discriminator (one) take optax.adam's eps 1e-8, which turns
# float-order noise in near-zero gradients into steps of up to the lr on
# a few weights (on an H100: 5.7e-4 and 2.6e-5 apart), so each is held by
# its gradient at the same params and by its outputs after the update,
# both relative to their largest, and its params are held absolutely on
# the weights whose gradient exceeds GAIL_STRONG_GRAD of the largest
PPO1_ATOL, GAIL_RTOL, DDPG_ATOL = 1e-5, 1e-4, 1e-6
GAIL_GRAD_RTOL, GAIL_OUT_RTOL = 1e-5, 1e-4
GAIL_STRONG_GRAD, GAIL_PARAM_ATOL = 1e-3, 1e-5


class _Timed:
    """Wraps ``module.name`` while in use: the wall time of each call to
    a sync (torch.cuda.synchronize before and after)."""

    def __init__(self, module, name):
        self.module, self.name, self.secs = module, name, []

    def __enter__(self):
        self.fn = fn = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def gail_run(spec) -> tuple:
    """learner_run of the GAIL recipe with the expert extraction and BC
    timed apart; the warp kernel launches once an agent step of the
    extraction (its recorded steps x stride) and of the rollouts."""
    from toybox_tpu_torch.rl import gail

    args = spec[2]

    def arg(name):
        return int(next(a for a in args if a.startswith(f"--{name}="))
                   .split("=")[1])

    n_envs, stride = arg("num_envs"), arg("expert_stride")
    n = arg("n_expert_transitions")
    ext_steps = -(-n // n_envs) * stride
    bc_steps = arg("bc_epochs") * -(-n // min(128, n))
    with _Timed(gail, "generate_expert_dataset") as ext, \
            _Timed(gail, "behavior_clone") as bc:
        launches, detail, state = learner_run(*spec, extra_steps=ext_steps)
    check(len(ext.secs) == len(bc.secs) == 1, "GAIL extracted or cloned "
          f"{len(ext.secs)} / {len(bc.secs)} times")
    first = next(csv.DictReader((SCRATCH / spec[0] / "progress.csv")
                                .read_text().splitlines()))
    bc_loss = float(first["bc_final_loss"])
    check(math.isfinite(bc_loss), f"gail bc_final_loss = {bc_loss}")
    ms_step = 1e3 * ext.secs[0] / ext_steps
    ms_bc = 1e3 * bc.secs[0] / bc_steps
    return launches, (
        f"{detail}; expert extraction {ext.secs[0]:.2f} s ({ext_steps} agent "
        f"steps of {n_envs} envs, {ms_step:.1f} ms a step: the recipe's "
        f"{BC_RECIPE_STEPS} steps in {BC_RECIPE_STEPS * ms_step / 6e4:.1f} "
        f"min); BC {bc.secs[0]:.2f} s ({bc_steps} minibatches of 128, "
        f"{ms_bc:.2f} ms each: the recipe's {BC_RECIPE_MINIBATCHES} in "
        f"{BC_RECIPE_MINIBATCHES * ms_bc / 6e4:.1f} min; its last epoch's "
        f"loss {bc_loss:.4f})"), state


def ddpg_run() -> str:
    """A main path: ``ddpg.learn`` on the box identity env at the JAX
    learning test's settings, DDPG_CYCLES cycles; the last logged mean
    reward beats DDPG_THRESHOLD and every metric is finite (DDPG saves
    nothing, as in JAX); ms a cycle; the busy share of 20 more cycles;
    ``run.main --alg=ddpg`` raises JAX's ValueError."""
    from toybox_tpu_torch.rl import ddpg
    from toybox_tpu_torch.rl.test_envs import make_box_identity_env

    log = _Rows()
    env = make_box_identity_env(DDPG_ENVS, dim=2, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ddpg.learn(env=env, action_dim=2,
                       total_timesteps=DDPG_CYCLES * DDPG_ENVS,
                       log_interval=DDPG_CYCLES, logger=log, device=DEV,
                       **DDPG_KW)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(state.update == DDPG_CYCLES and len(log.rows) == 1,
          f"ddpg ran {state.update} cycles, logged {len(log.rows)} rows")
    row = log.rows[0]
    for k in ("critic_loss", "actor_loss", "mean_reward"):
        check(math.isfinite(row[k]), f"ddpg {k} = {row[k]}")
    check(row["mean_reward"] > DDPG_THRESHOLD,
          f"ddpg mean reward {row['mean_reward']} <= {DDPG_THRESHOLD}")
    _, cycle, _ = ddpg.make_ddpg(env, 2, device=DEV, **DDPG_KW)

    def more():
        for _ in range(20):
            cycle(state)

    busy = _busy(more, "20 cycles")
    try:
        run.main(["--alg=ddpg", f"--device={DEV}"])
    except ValueError as e:
        check("toybox_tpu_torch.rl.ddpg.learn" in str(e), f"ddpg CLI: {e}")
    else:
        check(False, "run.main --alg=ddpg did not raise")
    ms = 1e3 * secs / DDPG_CYCLES
    return (f"ddpg on the box identity env ({DDPG_ENVS} envs, dim 2), "
            f"{DDPG_CYCLES} cycles in {secs:.2f} s ({ms:.2f} ms a cycle, "
            f"{DDPG_ENVS * DDPG_CYCLES / secs:.0f} env steps/s); mean reward {row['mean_reward']:.4f} (> "
            f"{DDPG_THRESHOLD}), critic loss {row['critic_loss']:.4g}, actor "
            f"loss {row['actor_loss']:.4g}; {busy}; run.main --alg=ddpg "
            "raises JAX's ValueError")


def imitation_update_phase() -> str:
    """One ppo1 update, one GAIL-TRPO update with its d-step and one DDPG
    cycle on cuda and on cpu from the same params, batch and draws (cpu
    collects at LEARNER_CHECK_ENVS Breakout envs make the batches): the
    params within each one's tolerance."""
    from toybox_tpu_torch.rl import ddpg, gail, ppo1
    from toybox_tpu_torch.rl.test_envs import make_box_identity_env

    env = make_rl_env("breakout", LEARNER_CHECK_ENVS, device="cpu")
    gen = torch.Generator().manual_seed(0)
    out = []

    def twin(module, d):
        return copy.deepcopy(module).to(d)

    def snap(module):
        return {k: v.clone() for k, v in module.state_dict().items()}

    # ppo1: cnn, 8 envs x 8 steps, minibatches of 16, 4 epochs
    init_fn, step = ppo1.make_ppo1(env, network="cnn",
                                   timesteps_per_actorbatch=8,
                                   optim_batchsize=16, device="cpu")
    st = init_fn(0)
    batch, buf = step.collect(st)
    perms = torch.stack([torch.randperm(64, generator=gen)
                         for _ in range(4)])
    before = snap(st.module)
    module = twin(st.module, DEV)
    states = {"cpu": st, DEV: ppo1.PPO1State(
        module=module, old=twin(st.old, DEV),
        adam=ppo.AdamState.zeros_like(list(module.parameters())),
        env_state=None, ob_rms=ppo1.ObFilter(
            st.ob_rms.mean.to(DEV), st.ob_rms.var.to(DEV),
            st.ob_rms.count.to(DEV)),
        kl_beta=st.kl_beta.to(DEV), generator=None)}
    for d, s in states.items():
        bufd = ppo.Rollout(**{f.name: getattr(buf, f.name).to(d)
                              for f in dataclasses.fields(buf)})
        step.optimize(s, (tuple(x.to(d) for x in batch), bufd),
                      {"perms": perms.to(d)})
    out.append(_check_moved("ppo1", {d: s.module for d, s in states.items()},
                            before, PPO1_ATOL))

    # GAIL-TRPO: cnn, 8 envs x 8 steps, random expert frames, one d-step
    eobs = torch.randint(0, 256, (256, 84, 84, 4), generator=gen,
                         dtype=torch.uint8)
    eacts = torch.randint(0, 4, (256,), generator=gen)
    init_fn, step = gail.make_gail_trpo(env, eobs, eacts, network="cnn",
                                        nsteps=8, max_kl=0.001, device="cpu")
    st = init_fn(0)
    batch, roll = step.collect(st)
    fobs, facts, _, _, fret = batch
    idx = torch.randint(0, 256, (1, 64), generator=gen)
    before = snap(st.module)
    vf, disc = twin(st.vf, DEV), twin(st.disc, DEV)
    states = {"cpu": st, DEV: gail.GAILTRPOState(
        module=twin(st.module, DEV), vf=vf,
        vf_adam=ppo.AdamState.zeros_like(list(vf.parameters())),
        disc=disc,
        disc_adam=ppo.AdamState.zeros_like(list(disc.parameters())),
        env_state=None, generator=None, expert_obs=eobs.to(DEV),
        expert_onehot=st.expert_onehot.to(DEV))}

    def fit(what, s, d):
        """(loss, outputs) of the value network or the discriminator on
        the batch (the d-step's expert rows for the discriminator)."""
        onehot = torch.nn.functional.one_hot(facts, 4).float().to(d)
        if what == "vf":
            v = s.vf(fobs.to(d))[1]
            return torch.square(v - fret.to(d)).mean(), v
        e = idx[0].to(d)
        return gail.disc_loss(s.disc, s.expert_obs[e], s.expert_onehot[e],
                              fobs.to(d), onehot, 1e-3)[0], \
            s.disc(fobs.to(d), onehot)

    def flat(tensors):
        return torch.cat([t.detach().reshape(-1).cpu() for t in tensors])

    grads, params0, outs0 = {}, {}, {}
    for what in ("vf", "disc"):
        params0[what] = flat(getattr(st, what).parameters())
        with torch.no_grad():
            outs0[what] = fit(what, st, "cpu")[1]
        grads[what] = {d: flat(torch.autograd.grad(
            fit(what, s, d)[0], list(getattr(s, what).parameters()),
            materialize_grads=True)) for d, s in states.items()}
    for d, s in states.items():
        step.optimize(s, (tuple(x.to(d) for x in batch),
                          {k: v.to(d) for k, v in roll.items()}),
                      {"expert_idx": idx.to(d)})
    check(float(states["cpu"].disc_metrics["disc_loss"]) > 0,
          "gail: the d-step did not run")
    out.append(_check_moved("gail-trpo policy", {
        d: s.module for d, s in states.items()}, before, GAIL_RTOL,
        relative=True))
    for what in ("vf", "disc"):
        g = grads[what]
        g_rel = float((g[DEV] - g["cpu"]).abs().max() / g["cpu"].abs().max())
        check(g_rel <= GAIL_GRAD_RTOL, f"gail-trpo {what}: the gradients at "
                                       f"the same params differ by {g_rel}")
        with torch.no_grad():
            o = {d: fit(what, s, d)[1].cpu() for d, s in states.items()}
        scale = o["cpu"].abs().max()
        o_moved = float((o["cpu"] - outs0[what]).abs().max() / scale)
        o_rel = float((o[DEV] - o["cpu"]).abs().max() / scale)
        check(o_moved > 10 * GAIL_OUT_RTOL, f"gail-trpo {what}: the update "
              f"moved the outputs by only {o_moved} of the largest")
        check(o_rel <= GAIL_OUT_RTOL, f"gail-trpo {what}: the outputs after "
                                      f"the update differ by {o_rel}")
        # the weights whose gradient stands above float noise: Adam's step
        # there is about lr * sign(g) on both devices
        strong = g["cpu"].abs() > GAIL_STRONG_GRAD * g["cpu"].abs().max()
        p = {d: flat(getattr(s, what).parameters())[strong]
             for d, s in states.items()}
        moved = float((p["cpu"] - params0[what][strong]).abs().max())
        off = float((p[DEV] - p["cpu"]).abs().max())
        check(moved > 10 * GAIL_PARAM_ATOL, f"gail-trpo {what}: the update "
              f"moved the strong-gradient params by only {moved}")
        check(off <= GAIL_PARAM_ATOL, f"gail-trpo {what}: cuda and cpu "
              f"differ by {off} on the strong-gradient params")
        out.append(f"gail-trpo {what}: gradient at the same params cuda vs "
                   f"cpu {g_rel:.3g} of its largest (tolerance "
                   f"{GAIL_GRAD_RTOL:g}); outputs moved {o_moved:.3g} of "
                   f"the largest, cuda vs cpu after the update {o_rel:.3g} "
                   f"(tolerance {GAIL_OUT_RTOL:g}); the {int(strong.sum())} "
                   f"of {strong.numel()} params with |g| > "
                   f"{GAIL_STRONG_GRAD:g} of the largest moved {moved:.3g}, "
                   f"cuda vs cpu {off:.3g} (tolerance {GAIL_PARAM_ATOL:g})")

    # DDPG: one cycle from the same init, targets and draws
    targets = torch.rand((2, LEARNER_CHECK_ENVS, 2), generator=gen) * 2 - 1
    draws = {"noise": torch.randn((LEARNER_CHECK_ENVS, 2), generator=gen),
             "idx": torch.randint(0, LEARNER_CHECK_ENVS, (64,),
                                  generator=gen)}
    states = {}
    for d in ("cpu", DEV):
        benv = make_box_identity_env(LEARNER_CHECK_ENVS, dim=2, device=d,
                                     targets=targets.to(d))
        init_fn, cycle, _ = ddpg.make_ddpg(benv, 2, learning_starts=0,
                                           actor_lr=3e-3, critic_lr=3e-3,
                                           buffer_size=256, device=d)
        states[d] = init_fn(0)
        if d == "cpu":
            before = {w: snap(getattr(states[d], w))
                      for w in ("actor", "critic")}
        cycle(states[d], {k: v.to(d) for k, v in draws.items()})
    for w in ("actor", "critic"):
        out.append(_check_moved(f"ddpg {w}", {
            d: getattr(s, w) for d, s in states.items()}, before[w],
            DDPG_ATOL))
    return "; ".join(out)


#: phase 21: HER at the JAX learning tests' settings
#: (tests/test_rl_learning.py:144 and :298) and learn's defaults
HER_ENVS, HER_BITS, HER_CYCLES, HER_THRESHOLD = 16, 6, 400, 0.5
HER_DDPG_CYCLES, HER_DDPG_LAST = 150, 20
HER_FUTURE_MIN, HER_NONE_MAX, HER_MARGIN = 0.5, 0.25, 0.3
HER_LEARN_EPISODES = 2000          # learn's default: 125 cycles of 16 envs
HER_BUSY_CYCLES = 5                # cycles in each busy-share window
# phase 21, cuda against cpu: one cycle of each learner from the same
# state and draws (DQN one Adam step, DDPG 4 SGD steps of two). Adam at
# eps 1e-8 turns the float-order noise of near-zero gradients into steps
# of up to the lr (ROADMAP hazards, as GAIL's in phase 20), so the params
# are held on the weights whose gradient exceeds HER_STRONG_GRAD of its
# tensor's largest at every step, the first step's gradients relative to
# their largest, and the losses relative
HER_STRONG_GRAD, HER_PARAM_ATOL, HER_GRAD_RTOL = 1e-3, 1e-5, 1e-5
HER_LOSS_RTOL, PD_RTOL = 1e-4, 1e-5
BENCH_ARGS = ["--game", "breakout", "--reps", "3", "--steps", "100",
              "--batch-sizes", "256,2048,8192"]


class _Grads:
    """Records the gradients of every ``ppo.adam_update`` call while in
    use, by the id of the first parameter updated."""

    def __enter__(self):
        self.fn, self.calls = ppo.adam_update, []

        def record(params, grads, *args, **kwargs):
            self.calls.append((id(params[0]), [g.detach().cpu().clone()
                                               for g in grads]))
            return self.fn(params, grads, *args, **kwargs)

        ppo.adam_update = record
        return self

    def __exit__(self, *exc):
        ppo.adam_update = self.fn

    def of(self, module) -> list:
        first = id(next(module.parameters()))
        return [g for k, g in self.calls if k == first]


def _her_twins(label, modules: dict, grads: dict, before: dict) -> str:
    """``modules[d]`` (name -> module) after one cycle on each device from
    the same params ``before`` (name -> state_dict), with the gradients
    of each Adam step (``grads[d]``, a _Grads): the first step's gradients
    within HER_GRAD_RTOL of their largest; the params whose gradient
    exceeds HER_STRONG_GRAD of its tensor's largest at every step moved
    and within HER_PARAM_ATOL."""
    out = []
    for name, mod in modules["cpu"].items():
        g = {d: grads[d].of(m[name]) for d, m in modules.items()}
        check(len(g["cpu"]) == len(g[DEV]) > 0, f"{label} {name}: "
              f"{len(g['cpu'])} and {len(g[DEV])} Adam steps")
        g_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(g[DEV][0], g["cpu"][0]))
        check(g_rel <= HER_GRAD_RTOL, f"{label} {name}: the first step's "
              f"gradients differ by {g_rel} of the largest")
        names = [n for n, _ in mod.named_parameters()]
        moved = off = 0.0
        n_strong = n_all = 0
        for i, n in enumerate(names):
            strong = torch.ones_like(g["cpu"][0][i], dtype=torch.bool)
            for step in g["cpu"]:
                strong &= step[i].abs() > HER_STRONG_GRAD * step[i].abs().max()
            p = {d: m[name].state_dict()[n].cpu() for d, m in modules.items()}
            if strong.any():
                moved = max(moved, float((p["cpu"] - before[name][n])
                                         .abs()[strong].max()))
                off = max(off, float((p[DEV] - p["cpu"]).abs()[strong].max()))
            n_strong += int(strong.sum())
            n_all += strong.numel()
        check(moved > 10 * HER_PARAM_ATOL, f"{label} {name}: the cycle moved "
              f"the strong-gradient params by only {moved}")
        check(off <= HER_PARAM_ATOL, f"{label} {name}: cuda and cpu differ "
              f"by {off} on the strong-gradient params")
        out.append(f"{label} {name}: first gradient cuda vs cpu {g_rel:.3g} "
                   f"of its largest (tolerance {HER_GRAD_RTOL:g}); the "
                   f"{n_strong} of {n_all} params with |g| > "
                   f"{HER_STRONG_GRAD:g} of the largest at all "
                   f"{len(g['cpu'])} steps moved {moved:.3g}, cuda vs cpu "
                   f"{off:.3g} (tolerance {HER_PARAM_ATOL:g})")
    return "; ".join(out)


def _loss_check(label, metrics: dict, keys) -> str:
    out = []
    for k in keys:
        a, b = float(metrics[DEV][k]), float(metrics["cpu"][k])
        rel = abs(a - b) / max(abs(b), 1e-12)
        check(rel <= HER_LOSS_RTOL, f"{label} {k}: cuda {a} vs cpu {b}")
        out.append(f"{k} {b:.6g} (cuda vs cpu {rel:.2g} relative)")
    return f"{label} " + ", ".join(out)


def her_learning_phase() -> str:
    """A main path of each HER learner on the card, at the JAX learning
    tests' settings and widths (GoalQNet 256-256, actor and critic 3 x
    256): make_her (HER_ENVS envs, HER_BITS bits, HER_CYCLES cycles)
    succeeds above HER_THRESHOLD; make_her_ddpg with the future strategy
    and without relabeling (HER_DDPG_CYCLES cycles each): the mean success
    of the last HER_DDPG_LAST cycles above HER_FUTURE_MIN and below
    HER_NONE_MAX, HER_MARGIN apart; then ``her.learn`` with each backend
    at its defaults; ms a cycle and the busy share of HER_BUSY_CYCLES
    more cycles;
    ``run.main --alg=her`` raises JAX's ValueError."""
    from toybox_tpu_torch.rl import her

    out = []
    init_fn, cycle, _ = her.make_her(HER_ENVS, HER_BITS, device=DEV)
    state = init_fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HER_CYCLES):
        state, last = cycle(state)
    success = float(last["success_rate"])
    secs = time.perf_counter() - t0
    check(success > HER_THRESHOLD, f"her bit-flip success {success}")
    check(math.isfinite(float(last["loss"])), "her loss not finite")
    busy = _busy(lambda: [cycle(state) for _ in range(HER_BUSY_CYCLES)],
                 f"{HER_BUSY_CYCLES} cycles")
    out.append(f"her (goal DQN) bit-flip {HER_ENVS} envs x {HER_BITS} bits, "
               f"{HER_CYCLES} cycles in {secs:.2f} s ({1e3 * secs / HER_CYCLES:.2f} "
               f"ms a cycle): success {success:.3f} (> {HER_THRESHOLD}); "
               f"{busy}")
    final = {}
    for strategy in ("future", "none"):
        init_fn, cycle = her.make_her_ddpg(HER_ENVS, 2,
                                           replay_strategy=strategy,
                                           device=DEV)
        state = init_fn(0)
        succ = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HER_DDPG_CYCLES):
            state, m = cycle(state)
            succ.append(m["success_rate"])
        final[strategy] = float(torch.stack(succ[-HER_DDPG_LAST:]).mean())
        secs = time.perf_counter() - t0
        for k in ("critic_loss", "actor_loss"):
            check(math.isfinite(float(m[k])), f"her-ddpg {k} not finite")
        busy = ""
        if strategy == "future":
            busy = "; " + _busy(
                lambda: [cycle(state) for _ in range(HER_BUSY_CYCLES)],
                f"{HER_BUSY_CYCLES} cycles")
        out.append(f"her-ddpg {strategy} {HER_ENVS} envs, dim 2, "
                   f"{HER_DDPG_CYCLES} cycles in {secs:.2f} s "
                   f"({1e3 * secs / HER_DDPG_CYCLES:.2f} ms a cycle): mean "
                   f"success of the last {HER_DDPG_LAST} "
                   f"{final[strategy]:.3f}{busy}")
    check(final["future"] > HER_FUTURE_MIN, f"her-ddpg future {final}")
    check(final["none"] < HER_NONE_MAX, f"her-ddpg none {final}")
    check(final["future"] > final["none"] + HER_MARGIN, f"her-ddpg {final}")
    for backend in ("dqn", "ddpg"):
        log = _Rows()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = her.learn(backend=backend, total_episodes=HER_LEARN_EPISODES,
                          logger=log, device=DEV)
        secs = time.perf_counter() - t0
        n = HER_LEARN_EPISODES // HER_ENVS
        check(state.t == n and len(log.rows) == 1,
              f"her.learn {backend}: {state.t} cycles, {len(log.rows)} rows")
        row = log.rows[0]
        check(all(math.isfinite(v) for k, v in row.items() if k != "wall"),
              f"her.learn {backend}: {row}")
        out.append(f"her.learn {backend} at its defaults: {n} cycles in "
                   f"{secs:.2f} s, success {row['success_rate']:.3f}")
    try:
        run.main(["--alg=her", f"--device={DEV}"])
    except ValueError as e:
        check("toybox_tpu_torch.rl.her.learn" in str(e), f"her CLI: {e}")
    else:
        check(False, "run.main --alg=her did not raise")
    out.append("run.main --alg=her raises JAX's ValueError")
    return "; ".join(out)


def her_update_phase() -> str:
    """One cycle of each HER learner on cuda and on cpu from the same
    state (the init's params, an empty ring) and the same draws, made on
    the cpu at the phase's widths: checked by ``_her_twins``, and the
    cycle's losses within HER_LOSS_RTOL."""
    from toybox_tpu_torch.rl import her

    gen = torch.Generator().manual_seed(0)

    def u(*shape):
        return torch.rand(shape, generator=gen)

    def samples(shape, size, T):
        tt = torch.randint(0, T, shape, generator=gen)
        return {"ep": torch.randint(0, size, shape, generator=gen), "tt": tt,
                "en": torch.randint(0, HER_ENVS, shape, generator=gen),
                "fut_off": her.future_offsets(tt, u(*shape), T),
                "her_u": u(*shape)}

    out = []
    T, B = HER_BITS, 128
    draws = {"bits": u(HER_ENVS, T) < .5, "goal": u(HER_ENVS, T) < .5,
             "explore_u": u(T, HER_ENVS),
             "rand_actions": torch.randint(0, T, (T, HER_ENVS), generator=gen),
             **samples((B,), 1, T)}
    mods, grads, metrics = {}, {}, {}
    for d in ("cpu", DEV):
        init_fn, cycle, _ = her.make_her(HER_ENVS, T, device=d)
        state = init_fn(0)
        if d == "cpu":
            before = {"qnet": copy.deepcopy(state.qnet.state_dict())}
        with _Grads() as grads[d]:
            _, metrics[d] = cycle(state, {k: v.to(d) for k, v in
                                          draws.items()})
        mods[d] = {"qnet": state.qnet}
    out.append(_her_twins("her", mods, grads, before))
    out.append(_loss_check("her", metrics, ("loss", "success_rate")))

    T, B, nb = 20, 256, 4
    draws = {"pos": u(HER_ENVS, 2) * 2 - 1, "goal": u(HER_ENVS, 2) * 2 - 1,
             "noise": torch.randn((T, HER_ENVS, 2), generator=gen),
             "rand_coin": u(T, HER_ENVS, 1), "rand_u": u(T, HER_ENVS, 2) * 2 - 1,
             **samples((nb, B), 1, T)}
    mods, grads, metrics = {}, {}, {}
    for d in ("cpu", DEV):
        init_fn, cycle = her.make_her_ddpg(HER_ENVS, 2, device=d)
        state = init_fn(0)
        if d == "cpu":
            before = {w: copy.deepcopy(getattr(state, w).state_dict())
                      for w in ("actor", "critic")}
        with _Grads() as grads[d]:
            _, metrics[d] = cycle(state, {k: v.to(d) for k, v in
                                          draws.items()})
        mods[d] = {w: getattr(state, w) for w in ("actor", "critic")}
    out.append(_her_twins("her-ddpg", mods, grads, before))
    out.append(_loss_check("her-ddpg", metrics, ("critic_loss", "actor_loss",
                                                 "success_rate")))
    return "; ".join(out)


def distributions_phase() -> str:
    """Each action distribution's neglogp, entropy, kl and mode on cuda
    against cpu on the same parameters (a cpu generator): within PD_RTOL of
    the largest, modes equal."""
    from toybox_tpu_torch.rl import distributions as pds

    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen) * 2

    n, ncats = 1024, (3, 5, 2)
    cases = {
        "categorical": (lambda p: pds.CategoricalPd(p[0]),
                        [r(n, 6), r(n, 6)], torch.randint(0, 6, (n,),
                                                          generator=gen)),
        "multi_categorical": (lambda p: pds.MultiCategoricalPd(p[0], ncats),
                              [r(n, 10), r(n, 10)],
                              torch.stack([torch.randint(0, k, (n,),
                                                         generator=gen)
                                           for k in ncats], -1)),
        "diag_gaussian": (lambda p: pds.DiagGaussianPd(p[0], p[1] * 0.3),
                          [r(n, 4), r(n, 4), r(n, 4), r(n, 4)], r(n, 4)),
        "bernoulli": (lambda p: pds.BernoulliPd(p[0]), [r(n, 8), r(n, 8)],
                      torch.randint(0, 2, (n, 8), generator=gen)),
    }
    worst = 0.0
    for name, (make, params, x) in cases.items():
        res = {}
        for d in ("cpu", DEV):
            p = [t.to(d) for t in params]
            half = len(p) // 2
            a, b = make(p[:half]), make(p[half:])
            res[d] = {"neglogp": a.neglogp(x.to(d)), "entropy": a.entropy(),
                      "kl": a.kl(b), "mode": a.mode()}
        check(torch.equal(res[DEV]["mode"].cpu(), res["cpu"]["mode"]),
              f"{name}: modes differ")
        for k in ("neglogp", "entropy", "kl"):
            want = res["cpu"][k]
            rel = float((res[DEV][k].cpu() - want).abs().max()
                        / want.abs().max())
            check(rel <= PD_RTOL, f"{name} {k}: cuda vs cpu {rel}")
            worst = max(worst, rel)
    return (f"{', '.join(cases)} at {n} rows: neglogp, entropy, kl within "
            f"{worst:.3g} of the largest cuda vs cpu (tolerance {PD_RTOL:g}),"
            " modes equal")


def image_class_update_phase() -> str:
    """One PPO update (cnn_small) on the image-class env on cuda and on
    cpu from the same params, batch and permutations, as phase 9's."""
    from toybox_tpu_torch.rl.test_envs import make_image_class_env

    n, nsteps = 16, 8
    env = make_image_class_env(n, n_classes=4, episode_len=4, device="cpu")
    init_fn, train_step, _ = ppo.make_ppo(
        env, network="cnn_small", nsteps=nsteps, nminibatches=2,
        noptepochs=2, lr=1e-3, cliprange=0.2, gamma=0.1, device="cpu")
    state = init_fn(0)
    before = {k: v.clone() for k, v in state.module.state_dict().items()}
    batch, _ = train_step.collect(state)
    module = copy.deepcopy(state.module).to(DEV)
    perms = [torch.randperm(n * nsteps, generator=state.generator)
             for _ in range(2)]
    hp = ppo.Hyper(nminibatches=2)
    for d, m in ((DEV, module), ("cpu", state.module)):
        ppo.update(m, ppo.AdamState.zeros_like(list(m.parameters())),
                   tuple(x.to(d) for x in batch), [p.to(d) for p in perms],
                   1e-3, 0.2, hp, env.num_actions)
    return "image-class ppo (cnn_small, 16 envs x 8 steps, 2 x 2): " + \
        _check_moved("params", {DEV: module, "cpu": state.module}, before,
                     UPDATE_ATOL)


def benchmark_phase() -> str:
    """``toybox_tpu_torch.benchmark.main`` for Breakout on the card: its
    JSON on a line of its own, every rate positive."""
    from toybox_tpu_torch import benchmark

    result = benchmark.main(BENCH_ARGS + ["--device", DEV])
    rates = {k: v["mean"] for k, v in result.items() if isinstance(v, dict)}
    check(rates and all(v > 0 for v in rates.values()),
          f"benchmark rates {rates}")
    return "benchmark.main " + " ".join(BENCH_ARGS) + ": " + ", ".join(
        f"{k} {v:.0f}" for k, v in rates.items())


def _params_diff(got, want) -> float:
    """The largest |got - want| over two modules' state_dicts; fails
    unless every entry lies within DIST_TOL (rtol, atol)."""
    rtol, atol = DIST_TOL
    worst = 0.0
    sd = want.state_dict()
    for k, v in got.state_dict().items():
        d = (v - sd[k]).abs()
        check(bool((d <= atol + rtol * sd[k].abs()).all()),
              f"{k} off by {float(d.max()):.3g} beyond {DIST_TOL}")
        worst = max(worst, float(d.max()))
    return worst


def distributed_phase() -> tuple:
    """Phase 22: (a) ``dryrun_multichip(1)`` and ``ppo.learn(mesh=)`` on
    a one-rank NCCL group on the card, each against the same run without
    a group (params within DIST_TOL);
    (b) the two-process launcher, two gloo ranks on cuda:0 (NCCL refuses
    two ranks on one GPU): the env phase's sums and states, the PPO
    params and the DQN sample against one process's; (c) cnn_im2col and
    cnn_coutpad on the card against the CPU. The launch counts are set to
    0 before (a)'s sharded runs and read after them, and (b)'s ranks
    report their own. Returns (launches, backend, detail)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from toybox_tpu_torch.parallel import dryrun as pdry
    from toybox_tpu_torch.parallel.mesh import make_mesh
    from toybox_tpu_torch.rl import acktr, dqn

    parts = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
        backend = dist.get_backend()
        try:
            _reset_launches()
            sharded = pdry.dryrun_multichip(1, device=DEV)
            state = ppo.learn(game="breakout", num_envs=DIST_ENVS,
                              network="cnn_small", nsteps=4, nminibatches=2,
                              noptepochs=1,
                              total_timesteps=DIST_ENVS * 4 * 4,
                              mesh=make_mesh(), device=DEV)
            torch.cuda.synchronize()
            launches = dict(render_cuda.LAUNCHES)
        finally:
            dist.destroy_process_group()
    check(backend == "nccl", f"the one-rank group's backend is {backend}")
    check(launches["breakout_frame_fused"] > 0
          and launches["breakout_frame_fused_warp"] > 0,
          f"a frame kernel did not launch in phase 22 (a): {launches}")
    check(state.update == 1, f"learn(mesh=) took {state.update} updates")
    plain = ppo.learn(game="breakout", num_envs=DIST_ENVS,
                      network="cnn_small", nsteps=4, nminibatches=2,
                      noptepochs=1, total_timesteps=DIST_ENVS * 4 * 4,
                      device=DEV)
    diffs = [f"learn {_params_diff(state.module, plain.module):.3g}"]
    for name, mod in (("ppo", ppo), ("dqn", dqn), ("acktr", acktr)):
        (s1, m1), (s0, m0) = sharded[name], mod.dryrun(1, "breakout",
                                                       device=DEV,
                                                       sharded=False)
        diffs.append(f"{name} {_params_diff(s1.module, s0.module):.3g}")
        for k in m0:
            check(bool(torch.isfinite(m1[k]) | torch.isnan(m0[k])),
                  f"{name} {k} not finite")
    t1 = time.perf_counter()
    parts.append(f"(a) dryrun_multichip(1) on a one-rank {backend} group: "
                 "params against no group, largest diff "
                 + ", ".join(diffs) + f" (learn(mesh=): {DIST_ENVS} envs, "
                 f"one update) ({t1 - t0:.2f} s)")

    opts = dict(game="breakout", envs=DIST_ENVS, steps=DIST_STEPS)
    ranks = pdry.run_ranks(("env", "train", "dqn"), world=2, device=DEV,
                           timeout=DIST_TIMEOUT, **opts)
    t2 = time.perf_counter()
    single = {name: pdry.PHASES[name](None, DEV, opts)
              for name in ("env", "train", "dqn")}
    checks = pdry.compare(ranks, single)
    check(all(ok for ok, _ in checks.values()),
          f"two gloo ranks against one process: {checks}")
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] += v
    parts.append(
        f"(b) 2 gloo ranks on {DEV}, {DIST_ENVS} Breakout envs: env "
        f"{DIST_STEPS} steps, {checks['env_game_over'][1]:.0f} game overs, "
        f"sums {checks['env_global_sums'][1]} and states"
        " equal one process's; PPO params within "
        f"{checks['train_params_close'][1]:.3g} (tol {pdry.PARAM_TOL}); DQN "
        f"sample slots {checks['dqn_sample_idx_equal'][1]} equal (ranks "
        f"{t2 - t1:.2f} s, one process {time.perf_counter() - t2:.2f} s)")

    t3 = time.perf_counter()
    from toybox_tpu_torch.rl.models import init_trunk, network_factory
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (HEADS_N, WARP, WARP, 4), dtype=np.uint8))
    for net in ("cnn_im2col", "cnn_coutpad"):
        cpu = network_factory(net)((WARP, WARP, 4))
        init_trunk(cpu, torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu).to(DEV)
        with torch.no_grad():
            want, got = cpu(x), card(x.to(DEV)).cpu()
        err, scale = _max_diff(got, want)
        tol = HEADS_ATOL * max(1.0, scale)
        check(err <= tol, f"{net} on the card off the cpu by {err:.3g}")
        parts.append(f"(c) {net} N={HEADS_N}: max diff {err:.3g} (tol "
                     f"{tol:.3g})")
    parts[-1] += f" ({time.perf_counter() - t3:.2f} s)"
    parts.append("launches " + ", ".join(f"{k} {v}" for k, v in
                                          launches.items() if v))
    return launches, backend, "; ".join(parts)


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

    # 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    built = render_cuda.build()
    check({g.kernel for g in GAMES} <= set(built),
          f"kernels missing from the build: {sorted(built)}")
    for g in GAMES:
        render_cuda.load_library(g.kernel)
        render_cuda.load_library(g.kernel, warp=True)
    phase(2, "build", t0, "; ".join(
        f"{path.name} [" + (" | ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line) or "cached") + "]"
        for path, log in built.values()))

    # 3. kernels against their plain versions
    err, timing = {}, {}
    for g in GAMES:
        t0 = time.perf_counter()
        sets, e, t = kernel_phase(g)
        err.update(e)
        timing.update(t)
        phase(3, "kernel", t0, "exact at N=" + ",".join(
            map(str, KERNEL_ENVS)) + " on " + " and ".join(sets) + "; "
              + "; ".join(
                  f"{k} N={v['n']}: kernel {v['ms']:.4f} ms (profiler), "
                  f"call {v['call_ms']:.4f} ms (events), plain "
                  f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
                  f"({v['bound_by']})" + (
                      f", replaced path (fused kernel + matmul warp) "
                      f"{v['replaced_ms']:.4f} ms" if "replaced_ms" in v
                      else "") + (
                      "; at N={n}: kernel {ms:.4f} ms, call {call_ms:.4f} "
                      "ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
                      "ms ({bound_by}), exact".format(**v["wide"])
                      if "wide" in v else "") for k, v in t.items()))

    # 4. engine, pipeline and policy: cuda against cpu
    state_dicts = {g.name: load_state_dict(MODELS / g.model) for g in GAMES}
    for g in GAMES:
        t0 = time.perf_counter()
        phase(4, "engine", t0, engine_phase(g) + "; "
              + pipeline_phase(g, state_dicts[g.name]) + "; "
              + warp_pipeline_phase(g)
              + ("; " + game_over_phase() if g.name == "breakout" else "")
              + ("; " + si_refused_phase() if g.name == "space_invaders"
                 else ""))

    # 5. serve: the main path of each game
    launches = {}
    for g in GAMES:
        t0 = time.perf_counter()
        mine, detail = serve_phase(g, state_dicts[g.name])
        launches.update(mine)
        phase(5, "serve", t0, detail)

    # 6. throughput
    for g in GAMES:
        t0 = time.perf_counter()
        phase(6, "throughput", t0, throughput_phase(
            g, state_dicts[g.name], timing[g.kernel + "_fused"]["ms"]))

    # 7. device profile of a short window of the serve and of throughput
    for g in GAMES:
        t0 = time.perf_counter()
        phase(7, "profile", t0, "; ".join(
            profile_phase(g, state_dicts[g.name], n, PROFILE_STEPS)
            for n in (SERVE_GAMES, THROUGHPUT_ENVS)))

    # 8. train: the slice's main path, Breakout at the recipe, and a
    # shorter update for the other two games (their warp kernels' path)
    for g in GAMES:
        t0 = time.perf_counter()
        full = g.name == "breakout"
        mine, detail, _ = train_phase(
            g, RECIPE["nsteps"] if full else TRAIN_SHORT_STEPS,
            TRAIN_UPDATES if full else 1)
        warp = g.kernel + "_fused_warp"
        launches[warp] = mine[warp]
        phase(8, "train", t0, detail)
    t0 = time.perf_counter()
    phase(8, "train profile", t0, train_profile_phase())
    t0 = time.perf_counter()
    wide_launches, detail = wide_train_phase()
    phase(8, "train 2048", t0, detail)
    t0 = time.perf_counter()
    phase(8, "update 2048", t0, wide_update_phase())

    # 9-11. the update on cuda against cpu, learning, the CLI
    t0 = time.perf_counter()
    phase(9, "update", t0, update_phase() + "; " + train_step_phase())
    t0 = time.perf_counter()
    phase(10, "identity", t0, identity_phase())
    t0 = time.perf_counter()
    phase(11, "cli", t0, cli_phase())

    # 12. behavior: the gate path of the intervention API
    gate_launches = {}
    for g in GAMES:
        t0 = time.perf_counter()
        mine, detail = behavior_phase(g, state_dicts[g.name])
        gate_launches.update(mine)
        phase(12, "behavior", t0, detail)

    # 13. heads: every committed checkpoint's eval head and serve chunk
    heads_launches = {}
    by_prefix = {g.model.split(".")[0]: g for g in GAMES}
    t13 = time.perf_counter()
    for path in sorted(MODELS.glob("*.model")):
        t0 = time.perf_counter()
        mine, detail = head_phase(path, by_prefix[path.name.split(".")[0]])
        for k, v in mine.items():
            heads_launches[k] = heads_launches.get(k, 0) + v
        phase(13, "heads", t0, detail)
    for g, suffix in zip(GAMES, ("a2c", "acer", "deepq")):
        t0 = time.perf_counter()
        phase(13, "heads", t0, adapter_phase(
            MODELS / f"{g.model.split('.')[0]}.{suffix}.model", g))
    phase(13, "heads", t13, "all heads")

    # 14. Gridworld: the engine, the pipeline, the PPO CLI, the profile
    t0 = time.perf_counter()
    phase(14, "gridworld", t0, gridworld_engine_phase() + "; "
          + gridworld_pipeline_phase() + "; " + gridworld_profile_phase())
    t0 = time.perf_counter()
    phase(14, "gridworld", t0, gridworld_cli_phase())

    # 15. the batched env's obs modes, on every game
    for name in [g.name for g in GAMES] + ["gridworld"]:
        t0 = time.perf_counter()
        phase(15, "obs modes", t0, obs_modes_phase(name))

    # 16. the state tools: samplers, fixtures, seed-state extraction
    t0 = time.perf_counter()
    phase(16, "state tools", t0, state_tools_phase())

    # 17. the gym surface, where gymnasium is installed
    t0 = time.perf_counter()
    try:
        import gymnasium  # noqa: F401
    except ImportError:
        print("phase 17 gym: not driven: gymnasium is not installed on "
              "this machine; the CPU tests (tests/test_torch_gym_env.py, "
              "test_torch_vec_env.py) hold the gym surface", flush=True)
    else:
        phase(17, "gym", t0, gym_phase())

    # 18. the on-policy learners after PPO, each through run.main
    learner_launches = {}
    for spec in LEARNERS:
        t0 = time.perf_counter()
        mine, detail, state = learner_run(*spec)
        for k, v in mine.items():
            learner_launches[k] = learner_launches.get(k, 0) + v
        phase(18, "learners", t0, detail)
        if spec[0] == "acktr":
            t0 = time.perf_counter()
            phase(18, "learners", t0, kfac_inverse_phase(state))
        del state
    t0 = time.perf_counter()
    phase(18, "learners", t0, learner_update_phase())

    # 19. the replay learners and TRPO, each through run.main
    for spec in REPLAY_LEARNERS:
        t0 = time.perf_counter()
        mine, detail, state = learner_run(*spec)
        for k, v in mine.items():
            learner_launches[k] = learner_launches.get(k, 0) + v
        phase(19, "replay learners", t0, detail)
        del state
    t0 = time.perf_counter()
    phase(19, "replay learners", t0, replay_update_phase())

    # 20. ppo1 and BC + GAIL through run.main, DDPG through ddpg.learn
    for spec in IMITATION_LEARNERS:
        t0 = time.perf_counter()
        run_fn = gail_run if spec[0] == "gail" else (
            lambda spec: learner_run(*spec))
        mine, detail, state = run_fn(spec)
        for k, v in mine.items():
            learner_launches[k] = learner_launches.get(k, 0) + v
        phase(20, "imitation", t0, detail)
        del state
    t0 = time.perf_counter()
    phase(20, "imitation", t0, ddpg_run())
    t0 = time.perf_counter()
    phase(20, "imitation", t0, imitation_update_phase())

    # 21. the goal learners (HER) and the tools: distributions, the
    # image-class env, the bench harness
    t21 = time.perf_counter()
    phase(21, "goal learners", t21, her_learning_phase())
    t0 = time.perf_counter()
    phase(21, "goal learners", t0, her_update_phase())
    t0 = time.perf_counter()
    phase(21, "tools", t0, distributions_phase() + "; "
          + image_class_update_phase())
    t0 = time.perf_counter()
    phase(21, "tools", t0, benchmark_phase())
    phase(21, "goal learners and tools", t21, "the whole phase")

    # 22. the distributed layer: the multi-rank dryruns, learn(mesh=), the
    # two-process launcher, and the layout variants of NatureCNN
    t0 = time.perf_counter()
    dist_launches, _, detail = distributed_phase()
    phase(22, "distributed", t0, detail)

    kernels = []
    for g in GAMES:
        for name, line in zip((g.kernel, g.kernel + "_fused",
                               g.kernel + "_fused_warp"),
                              g.replaces + g.replaces[1:]):
            t = timing[name]
            kernels.append(dict(
                name=name, route="cuda",
                source=f"toybox_tpu_torch/csrc/{g.kernel}.cu",
                replaces=f"{PALLAS}:{line}", launches=launches[name],
                gate_launches=gate_launches.get(name, 0),
                heads_launches=heads_launches.get(name, 0),
                learner_launches=learner_launches.get(name, 0),
                distributed_launches=dist_launches.get(name, 0),
                max_abs_err=err[name], ms=t["ms"], call_ms=t["call_ms"],
                plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=None,
                **({"wide": t["wide"], "wide_launches": wide_launches[name]}
                   if "wide" in t else {})))
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

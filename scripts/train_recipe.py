#!/usr/bin/env python3
"""Train PPO Breakout at its recipe through the port's CLI on one GPU, in
resumable pieces, then play the saved model's regress gate.

    python3 scripts/train_recipe.py [--out build/recipe] [--seed 0] \
        [--budget 3000] [--network_kwargs "{'dtype':'bfloat16'}"] \
        [--warp kernel|matmul] [--tf32] [--control models/X.model]

The recipe is ``python -m toybox_tpu_torch.run --alg=ppo
--env=BreakoutToyboxNoFrameskip-v4 --num_envs=1024 --num_timesteps=1.2e8
--checkpoint_freq=10`` (228 updates of 1 024 x 128 x 4 frames: 1.2e8
frames, floored to whole updates as ``ppo.learn`` floors them),
driven through ``run.main`` in this process so that the frame kernels'
launch counts can be read after it. A piece resumes from the newest
checkpoint under ``<out>/ckpt`` (only the newest is kept), logs to
``<out>/log<k>`` (``progress.csv``: one row an update) and, once
``--budget`` seconds have passed, stops right after its next checkpoint,
so that the pieces' logs hold each update once. Each piece appends one
JSON line to ``<out>/pieces.jsonl``: its first and last update, wall
seconds, frames/s and kernel launches. Run it again until the model
``<out>/Breakout.port.model`` is written.

Three arms change the run in this process only, never the package's
defaults: ``--network_kwargs`` passes a python literal through to
``ppo.learn`` (the bf16 recipe: ``"{'dtype':'bfloat16'}"``, a bf16 trunk
over f32 parameters); ``--warp matmul`` builds the env with
``make_rl_env(..., inkernel_warp=False)``, the fused max-pool kernel and
the two warp matmuls (the JAX package's training obs path) instead of
the in-kernel warp; ``--tf32`` leaves TF32 on for the convolutions and
matmuls of the training (``full_f32`` is replaced by its opposite here),
where the port otherwise trains in strict f32. The gates always play in
f32. A piece's arm is kept in ``pieces.jsonl``; a resumed piece must
be given the same arm. ``--num_timesteps`` shortens the recipe (the
lr and clip then anneal over its updates) for a rehearsal.

Then it plays ``python -m toybox_tpu_torch.regress`` (threshold 50) at
seeds 0–4 for the saved model and for the ``--control`` model
(``models/Breakout.regress.model`` unless told), five processes at a
time, and prints one JSON line a gate and a summary: the card's name and
power limit, every piece, ``eprewmean`` every 10 updates, and the gates'
means. ``--no_gate`` stops after the training.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GAME_ENV = "BreakoutToyboxNoFrameskip-v4"
FRAMES = 120_000_000
BATCH_FRAMES = 1024 * 128 * 4           # one update: envs x nsteps x skip
MODEL = "Breakout.port.model"
GATE_SEEDS = range(5)


class _Stop(Exception):
    """Raised after the first checkpoint written past the budget."""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def set_arm(warp: str, tf32: bool) -> None:
    """Point this process's ``ppo.learn`` at the chosen warp and
    precision (the package is left as it is on disk)."""
    import torch

    from toybox_tpu_torch import run
    from toybox_tpu_torch.envs import pipeline
    from toybox_tpu_torch.rl import ppo

    if warp == "matmul":
        def matmul_warp_env(*args, **kwargs):
            return pipeline.make_rl_env(*args, **dict(kwargs,
                                                      inkernel_warp=False))
        ppo.make_rl_env = matmul_warp_env
    if tf32:
        def tf32_on() -> None:
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
        run.full_f32 = ppo.full_f32 = tf32_on


def train_piece(out: Path, budget: float, seed: int, frames: int,
                arm: dict) -> dict:
    from toybox_tpu_torch import run
    from toybox_tpu_torch.ops import render_cuda
    from toybox_tpu_torch.utils import checkpoint as ckpt_mod

    updates = frames // BATCH_FRAMES

    ckpt_dir = out / "ckpt"
    latest = ckpt_mod.latest_checkpoint(str(ckpt_dir))
    first = int(latest.rsplit("_", 1)[1]) + 1 if latest else 1
    piece = len(list(out.glob("log*")))
    deadline = time.perf_counter() + budget
    save = ckpt_mod.Checkpointer.maybe_save

    def maybe_save(self, state, n):
        save(self, state, n)
        if self.ckpt_dir is None or n % self.freq:
            return
        for old in Path(self.ckpt_dir).glob("ckpt_*"):
            if old.name != f"ckpt_{n}":
                old.unlink()
        if n < updates and time.perf_counter() > deadline:
            raise _Stop(n)

    argv = ["--alg=ppo", f"--env={GAME_ENV}", "--num_envs=1024",
            f"--num_timesteps={frames}", f"--seed={seed}",
            f"--save_path={out / MODEL}", f"--checkpoint_path={ckpt_dir}",
            "--checkpoint_freq=10", f"--log_path={out / f'log{piece}'}"]
    if arm["network_kwargs"]:
        argv.append(f"--network_kwargs={arm['network_kwargs']}")
    print("python -m toybox_tpu_torch.run " + " ".join(argv)
          + f"  (warp {arm['warp']}, tf32 {arm['tf32']})", flush=True)
    set_arm(arm["warp"], arm["tf32"])
    render_cuda.build()
    for k in render_cuda.LAUNCHES:
        render_cuda.LAUNCHES[k] = 0
    ckpt_mod.Checkpointer.maybe_save = maybe_save
    t0 = time.perf_counter()
    try:
        run.main(argv)
        last = updates
    except _Stop as stop:
        last = stop.args[0]
    finally:
        ckpt_mod.Checkpointer.maybe_save = save
    wall = time.perf_counter() - t0
    frames = (last - first + 1) * BATCH_FRAMES
    row = dict(piece=piece, first_update=first, last_update=last, arm=arm,
               wall_s=wall, frames_per_s=frames / wall,
               launches={k: v for k, v in render_cuda.LAUNCHES.items()
                         if v}, card=card())
    with open(out / "pieces.jsonl", "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return row


def gates(out: Path, seeds: list, control: Path) -> list:
    jobs = []
    for label, path in (("port", out / MODEL), ("committed", control)):
        for s in seeds:
            jobs.append((label, s, [sys.executable, "-m",
                                    "toybox_tpu_torch.regress",
                                    f"--env={GAME_ENV}",
                                    f"--load_path={path}", f"--seed={s}"]))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    rows, running = [], []
    while jobs or running:
        while jobs and len(running) < 5:
            label, s, cmd = jobs.pop(0)
            running.append((label, s, time.perf_counter(), subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        label, s, t0, proc = running.pop(0)
        text = proc.communicate()[0]
        m = re.search(r"^scores: (\[.*\])$", text, re.M)
        a = re.search(r"^average: ([-0-9.]+)", text, re.M)
        row = dict(model=label, seed=s, rc=proc.returncode,
                   seconds=time.perf_counter() - t0,
                   scores=json.loads(m.group(1)) if m else None,
                   average=float(a.group(1)) if a else None)
        if row["average"] is None:
            print(text[-2000:])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "recipe"))
    ap.add_argument("--seed", type=int, default=0,
                    help="the training run's seed")
    ap.add_argument("--budget", type=float, default=3000.0,
                    help="seconds of training, then stop at the next "
                         "checkpoint")
    ap.add_argument("--num_timesteps", type=float, default=FRAMES,
                    help="frames of the run (the recipe's 1.2e8 unless "
                         "rehearsing)")
    ap.add_argument("--network_kwargs", default=None,
                    help="a python literal passed to ppo.learn, e.g. "
                         "\"{'dtype':'bfloat16'}\"")
    ap.add_argument("--warp", choices=("kernel", "matmul"),
                    default="kernel",
                    help="the in-kernel warp (the port's default) or the "
                         "fused max-pool kernel and the warp matmuls")
    ap.add_argument("--tf32", action="store_true",
                    help="train with TF32 on (the port trains in f32)")
    ap.add_argument("--control", default=str(ROOT / "models" /
                                              "Breakout.regress.model"),
                    help="the model gated beside the trained one")
    ap.add_argument("--no_gate", action="store_true",
                    help="stop after the training")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    frames = int(args.num_timesteps)
    updates = frames // BATCH_FRAMES
    arm = dict(network_kwargs=args.network_kwargs, warp=args.warp,
               tf32=args.tf32)
    print(f"card: {card()}", flush=True)
    if not (out / MODEL).exists():
        train_piece(out, args.budget, args.seed, frames, arm)
    if not (out / MODEL).exists():
        print("the recipe is not finished: run this again to resume")
        return 3
    rows = [] if args.no_gate else gates(out, GATE_SEEDS,
                                         Path(args.control).resolve())
    progress = []
    for log in sorted(out.glob("log*/progress.csv")):
        with open(log) as f:
            progress += list(csv.DictReader(f))
    by_update = {int(float(r["misc/nupdates"])): r for r in progress}
    pieces = [json.loads(line) for line in open(out / "pieces.jsonl")]
    wall = sum(p["wall_s"] for p in pieces)
    launches = {}
    for p in pieces:
        for k, v in p["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(json.dumps(dict(
        card=card(), arm=arm, seed=args.seed, pieces=pieces, wall_s=wall,
        frames_per_s=updates * BATCH_FRAMES / wall,
        each_update_once=(len(progress) == updates
                          and sorted(by_update) == list(range(1,
                                                              updates + 1))),
        eprewmean_every_10={u: float(r["eprewmean"])
                            for u, r in sorted(by_update.items())
                            if u % 10 == 0 or u == updates},
        launches=launches,
        gate_means={label: [r["average"] for r in rows
                            if r["model"] == label]
                    for label in ("port", "committed")})))
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

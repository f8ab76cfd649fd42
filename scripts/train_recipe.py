#!/usr/bin/env python3
"""Train PPO Breakout at its recipe through the port's CLI on one GPU, in
resumable pieces, then play the saved model's regress gate.

    python3 scripts/train_recipe.py [--out build/recipe] [--seed 0] \
        [--budget 3000]

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

Then it plays ``python -m toybox_tpu_torch.regress`` (threshold 50) at
seeds 0–4 for the saved model and for ``models/Breakout.regress.model``, five processes at a
time, and prints one JSON line a gate and a summary: the card's name and
power limit, every piece, ``eprewmean`` every 10 updates, and the gates'
means.
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
UPDATES = FRAMES // (1024 * 128 * 4)
MODEL = "Breakout.port.model"
GATE_SEEDS = range(5)


class _Stop(Exception):
    """Raised after the first checkpoint written past the budget."""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def train_piece(out: Path, budget: float, seed: int) -> dict:
    from toybox_tpu_torch import run
    from toybox_tpu_torch.ops import render_cuda
    from toybox_tpu_torch.utils import checkpoint as ckpt_mod

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
        if n < UPDATES and time.perf_counter() > deadline:
            raise _Stop(n)

    argv = ["--alg=ppo", f"--env={GAME_ENV}", "--num_envs=1024",
            f"--num_timesteps={FRAMES}", f"--seed={seed}",
            f"--save_path={out / MODEL}", f"--checkpoint_path={ckpt_dir}",
            "--checkpoint_freq=10", f"--log_path={out / f'log{piece}'}"]
    print("python -m toybox_tpu_torch.run " + " ".join(argv), flush=True)
    render_cuda.build()
    for k in render_cuda.LAUNCHES:
        render_cuda.LAUNCHES[k] = 0
    ckpt_mod.Checkpointer.maybe_save = maybe_save
    t0 = time.perf_counter()
    try:
        run.main(argv)
        last = UPDATES
    except _Stop as stop:
        last = stop.args[0]
    finally:
        ckpt_mod.Checkpointer.maybe_save = save
    wall = time.perf_counter() - t0
    frames = (last - first + 1) * 1024 * 128 * 4
    row = dict(piece=piece, first_update=first, last_update=last,
               wall_s=wall, frames_per_s=frames / wall,
               launches={k: v for k, v in render_cuda.LAUNCHES.items()
                         if v}, card=card())
    with open(out / "pieces.jsonl", "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return row


def gates(out: Path, seeds: list) -> list:
    jobs = []
    for label, path in (("port", out / MODEL),
                        ("committed", ROOT / "models" /
                         "Breakout.regress.model")):
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
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)
    if not (out / MODEL).exists():
        train_piece(out, args.budget, args.seed)
    if not (out / MODEL).exists():
        print("the recipe is not finished: run this again to resume")
        return 3
    rows = gates(out, GATE_SEEDS)
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
        card=card(), pieces=pieces, wall_s=wall,
        frames_per_s=UPDATES * 1024 * 128 * 4 / wall,
        each_update_once=(len(progress) == UPDATES
                          and sorted(by_update) == list(range(1,
                                                              UPDATES + 1))),
        eprewmean_every_10={u: float(r["eprewmean"])
                            for u, r in sorted(by_update.items())
                            if u % 10 == 0 or u == UPDATES},
        launches=launches,
        gate_means={label: [r["average"] for r in rows
                            if r["model"] == label]
                    for label in ("port", "committed")})))
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the port's gates on one GPU, several processes at a time: the
regress gate (``python -m toybox_tpu_torch.regress``) of committed
checkpoints and the behavioral gate (``python -m
toybox_tpu_torch.sample_tests <game> --family=<f>``) of model families.

    python3 scripts/port_gates.py [--jobs 6] [--seeds 0] \
        [--regress all|none|<file>,...] [--families a2c,acer,...|none] \
        [--games breakout,space_invaders,amidar] [--budget SECONDS]

The kernels are built once before the gates start. Each gate writes its
output to build/gates/<name>.log; one JSON line a gate (its command,
exit code, wall time, and the scores or verdicts its output printed) goes
to build/gates/summary.jsonl and to standard output, and a table ends
the run.
``--regress all`` takes every models/*.model but the ``*.regress.model``
files (the ppo family's, gated since the port began). Wall times are
those of gates sharing the card and the host's cores with ``--jobs - 1``
others.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from toybox_tpu_torch.ops import render_cuda  # noqa: E402
from toybox_tpu_torch.rl.eval_adapter import checkpoint_head  # noqa: E402
from toybox_tpu_torch.sample_tests.families import FAMILIES  # noqa: E402

GAMES = ("breakout", "space_invaders", "amidar")
NEW_FAMILIES = tuple(f for f in FAMILIES if f != "ppo")
OUT = ROOT / "build" / "gates"


def regress_job(path: Path, seed: int) -> tuple:
    alg, network = checkpoint_head(path.name)
    env = path.name.split(".")[0] + "ToyboxNoFrameskip-v4"
    return (f"regress-{path.stem}-s{seed}",
            ["-m", "toybox_tpu_torch.regress", f"--env={env}",
             f"--alg={alg}", f"--network={network}",
             f"--load_path={path.relative_to(ROOT)}", f"--seed={seed}"])


def behavior_job(family: str, game: str, seed: int) -> tuple:
    return (f"behavior-{family}-{game}-s{seed}",
            ["-m", "toybox_tpu_torch.sample_tests", game,
             f"--family={family}", f"--seed={seed}"])


def parse(name: str, text: str) -> dict:
    """What a gate's output says: the regress gate's scores and average,
    or each scenario's verdict, scores and control."""
    out = {}
    if name.startswith("regress"):
        m = re.search(r"^scores: (\[.*\])$", text, re.M)
        a = re.search(r"^average: ([-0-9.]+)", text, re.M)
        if m and a:
            out["scores"] = json.loads(m.group(1))
            out["average"] = float(a.group(1))
        out["verdict"] = ("PASS" if re.search(r"^PASS$", text, re.M)
                          else "FAIL" if "REGRESSION" in text else "ERROR")
        return out
    scenarios = {}
    # each scenario's line, printed as it ends (with its seconds) and again
    # at the end of the gate
    for m in re.finditer(r"^ *(PASS|FAIL|WAIVED) (\w+): scores=(\[[^\]]*\])"
                         r"(?: control=(\[[^\]]*\]))?(?: \(([0-9.]+) s\))?$",
                         text, re.M):
        d = scenarios.setdefault(m.group(2), {})
        d.update(verdict=m.group(1), scores=json.loads(m.group(3)),
                 control=json.loads(m.group(4)) if m.group(4) else None)
        if m.group(5):
            d["seconds"] = float(m.group(5))
    launches = re.search(r"^frame kernel launches: (\{.*\})$", text, re.M)
    if launches:
        out["launches"] = {k: v for k, v in json.loads(
            launches.group(1).replace("'", '"')).items() if v}
    out["scenarios"] = scenarios
    out["verdict"] = ("ERROR" if not scenarios else
                      "PARTIAL" if "elapsed:" not in text else
                      "FAIL" if "BEHAVIORAL REGRESSION" in text else "PASS")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--regress", default="all")
    ap.add_argument("--families", default=",".join(NEW_FAMILIES))
    ap.add_argument("--games", default=",".join(GAMES))
    ap.add_argument("--budget", type=float, default=None,
                    help="seconds: then stop the running gates (recorded "
                         "as cut) and start no other")
    args = ap.parse_args(argv)
    OUT.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.regress == "all":
        models = [p for p in sorted((ROOT / "models").glob("*.model"))
                  if not p.name.endswith(".regress.model")]
    elif args.regress == "none":
        models = []
    else:
        models = [ROOT / "models" / f for f in args.regress.split(",")]
    families = [] if args.families == "none" else args.families.split(",")
    games = args.games.split(",")
    # the longest first: Breakout's behavioral gates play up to 22 500
    # agent steps, a regress gate up to 5 000
    jobs = [behavior_job(f, g, s) for g in games for s in seeds
            for f in families]
    jobs += [regress_job(p, s) for s in seeds for p in models]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; {len(jobs)} gates, {args.jobs} at a time",
          flush=True)
    t_build = time.perf_counter()
    render_cuda.build()
    print(f"kernels built in {time.perf_counter() - t_build:.1f} s",
          flush=True)

    env = dict(os.environ, OMP_NUM_THREADS="1")
    todo, running, rows = list(jobs), {}, []
    t_all = time.perf_counter()
    with open(OUT / "summary.jsonl", "a") as summary:
        while todo or running:
            while todo and len(running) < args.jobs:
                name, cmd = todo.pop(0)
                log = open(OUT / f"{name}.log", "w")
                proc = subprocess.Popen([sys.executable, *cmd], cwd=ROOT,
                                        stdout=log, stderr=subprocess.STDOUT,
                                        env=env)
                running[name] = (proc, log, cmd, time.perf_counter())
            time.sleep(0.5)
            cut = (args.budget is not None
                   and time.perf_counter() - t_all > args.budget)
            if cut:
                for proc, *_ in running.values():
                    proc.kill()
                    proc.wait()
                print("budget spent; not started: "
                      + ", ".join(n for n, _ in todo), flush=True)
                todo = []
            for name in [n for n, r in running.items()
                         if r[0].poll() is not None]:
                proc, log, cmd, t0 = running.pop(name)
                log.close()
                row = dict(name=name, command=" ".join(cmd),
                           rc="cut" if cut else proc.returncode,
                           seconds=round(time.perf_counter() - t0, 1),
                           card=card)
                row.update(parse(name, (OUT / f"{name}.log").read_text()))
                rows.append(row)
                line = json.dumps(row)
                print(line, flush=True)
                summary.write(line + "\n")
                summary.flush()
    print(f"all gates in {time.perf_counter() - t_all:.1f} s on {card}")
    for row in sorted(rows, key=lambda r: r["name"]):
        what = (f"average {row.get('average')}" if "average" in row else
                " ".join(f"{k}:{v.get('verdict')}"
                         for k, v in row.get("scenarios", {}).items()))
        print(f"{row['name']:48s} {row['verdict']:5s} rc {row['rc']!s:4s} "
              f"{row['seconds']:7.1f} s  {what}")
    return 0 if all(r["verdict"] != "ERROR" and r["rc"] != "cut"
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

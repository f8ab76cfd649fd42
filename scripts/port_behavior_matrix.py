"""Run every committed model family through every behavioral scenario on
the PyTorch + CUDA port and write the family x scenario matrix per game,
the counterpart of scripts/behavior_matrix.py: how training regimes
respond to white-box interventions.

    python3 scripts/port_behavior_matrix.py                 # all 3 games
    python3 scripts/port_behavior_matrix.py --games breakout \
        --families ppo,a2c [--episodes N] [--max-frames F] [--seed S] \
        [--device cuda|cpu]

Each family's checkpoint is loaded into its eval head
(``rl.eval_adapter.load_eval_params``) and played through
``sample_tests.runner.run_all_gated`` with the family's calibrated or
waived checks (``sample_tests/families.py``). Writes
build/BEHAVIOR_torch.md (the markdown matrix) and
build/behavior_matrix_torch.json (every score), each cell with the keys
of scripts/behavior_matrix.py's; each family and game's wall time is
printed. Always exits 0: the gate (nonzero on a regression) is
scripts/port_behavior_tests.sh. TF32 is off. Runs on ``cuda`` unless
given ``--device cpu``; with no card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GAMES = ("breakout", "amidar", "space_invaders")


def run_family(family, game, episodes, max_frames, seed, device):
    import numpy as np

    from toybox_tpu_torch.rl.eval_adapter import load_eval_params
    from toybox_tpu_torch.sample_tests.families import (FAMILIES,
                                                        model_path,
                                                        overrides_for)
    from toybox_tpu_torch.sample_tests.runner import run_all_gated

    spec = FAMILIES[family]
    path = model_path(family, game)
    if not os.path.exists(path):
        return {"missing_model": path}
    state_dict = load_eval_params(spec["alg"], spec["network"], path, game,
                                  device).state_dict()
    results = run_all_gated(game, state_dict=state_dict, alg=spec["alg"],
                            network=spec["network"], episodes=episodes,
                            seed=seed, max_frames=max_frames,
                            overrides=overrides_for(family, game),
                            device=device)
    for r in results.values():
        del r["seconds"]            # the family and game's time is printed
        r["mean"] = round(float(np.mean(r["scores"])), 1)
        if r["control"] is not None:
            r["control_mean"] = round(float(np.mean(r["control"])), 1)
    return results


def _status(c) -> str:
    return ("WAIVED" if c["passed"] is None
            else "PASS" if c["passed"] else "FAIL")


def to_markdown(matrix, games, families, where: str):
    lines = ["# Behavioral-scenario matrix of the PyTorch + CUDA port",
             "",
             "Generated by `scripts/port_behavior_matrix.py` on "
             f"{where}. Cell = mean raw score over the scenario's episodes "
             "(control mean in parens for relative checks); PASS/FAIL per "
             "the calibrated check, WAIVED = explicitly waived for that "
             "family (rationale in "
             "`toybox_tpu_torch/sample_tests/families.py`), n/a = no "
             "committed model.", ""]
    for game in games:
        fams = [f for f in families if game in matrix.get(f, {})]
        scenarios = next((list(matrix[f][game]) for f in fams
                          if "missing_model" not in matrix[f][game]), [])
        if not fams:
            continue
        lines += [f"## {game}", "",
                  "| family | " + " | ".join(scenarios) + " |",
                  "|---" * (len(scenarios) + 1) + "|"]
        for f in fams:
            r = matrix[f][game]
            if "missing_model" in r:
                row = ["n/a"] * len(scenarios)
            else:
                row = []
                for s in scenarios:
                    c = r[s]
                    cell = f"{c['mean']}"
                    if c.get("control_mean") is not None:
                        cell += f" ({c['control_mean']})"
                    row.append(f"{cell} {_status(c)}")
            lines.append(f"| {f} | " + " | ".join(row) + " |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--games", default=",".join(GAMES))
    p.add_argument("--families", default=None,
                   help="comma list; default: every registered family")
    p.add_argument("--episodes", type=int, default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-md", default=os.path.join(ROOT, "build",
                                                    "BEHAVIOR_torch.md"))
    p.add_argument("--out-json", default=os.path.join(
        ROOT, "build", "behavior_matrix_torch.json"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from toybox_tpu_torch.benchmark import device_line, require_device
    from toybox_tpu_torch.regress import full_f32
    from toybox_tpu_torch.sample_tests.families import FAMILIES

    dev = require_device(args.device)
    full_f32()
    games = [g for g in args.games.split(",") if g]
    families = ([f for f in args.families.split(",") if f]
                if args.families else list(FAMILIES))

    t_all = time.perf_counter()
    matrix = {}
    for family in families:
        matrix[family] = {}
        for game in games:
            t0 = time.perf_counter()
            r = run_family(family, game, args.episodes, args.max_frames,
                           args.seed, str(dev))
            matrix[family][game] = r
            dt = time.perf_counter() - t0
            if "missing_model" in r:
                print(f"[{family}/{game}] no model ({r['missing_model']})",
                      flush=True)
                continue
            cells = " ".join(f"{name}={_status(c)}:{c['mean']}"
                             for name, c in r.items())
            print(f"[{family}/{game}] ({dt:.1f}s) {cells}", flush=True)

    where = device_line(dev)
    for path in (args.out_json, args.out_md):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(args.out_json, "w") as f:
        json.dump(matrix, f, indent=1)
    with open(args.out_md, "w") as f:
        f.write(to_markdown(matrix, games, families, where))
    if dev.type == "cuda":
        from toybox_tpu_torch.ops.render_cuda import LAUNCHES
        print(f"frame kernel launches: {LAUNCHES}")
    print(f"elapsed: {time.perf_counter() - t_all:.1f} s on {where} "
          f"(torch {torch.__version__})")
    print(f"wrote {args.out_md} + {args.out_json}")
    return matrix


if __name__ == "__main__":
    main()

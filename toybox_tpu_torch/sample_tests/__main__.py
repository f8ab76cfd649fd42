"""CLI of the behavioral acceptance scenarios (port of
toybox_tpu.sample_tests.__main__).

    python -m toybox_tpu_torch.sample_tests breakout --family=ppo \
        [--episodes=N] [--seed=S] [--max-frames=F] [--device=cuda]

Two modes:

- gate (``--family`` or ``--load_path`` given): every scenario played
  batched with the trained checkpoint, loaded into its eval head
  (``rl/eval_adapter.py`` ``load_eval_params``; any of the nine families,
  recurrent networks included), each scenario's ``check`` applied
  (against a control run of the same policy on the unmodified game where
  it needs one); exits 1 if any scenario fails. ``--network`` defaults to
  the family's, else to the alg's (``run.ALG_DEFAULTS``).
- smoke (neither given): each scenario per frame through the facade with
  a uniform-random policy; reports scores and always exits 0.

Runs on ``cuda`` unless ``--device=cpu``. Convolutions and matmuls run in
full f32 (TF32 off), as the JAX reference computes them.
"""

from __future__ import annotations

import argparse
import sys
import time


def _line(name: str, r: dict, gating: bool) -> str:
    status = (("WAIVED" if gating else "SMOKE") if r["passed"] is None
              else "PASS" if r["passed"] else "FAIL")
    ctrl = f" control={r['control']}" if r["control"] is not None else ""
    return f"{status} {name}: scores={r['scores']}{ctrl}"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("game")
    parser.add_argument("--alg", type=str, default="ppo")
    parser.add_argument("--family", type=str, default=None,
                        help="gate a registered model family (families.py):"
                             " sets alg/network/model and applies the "
                             "family's check overrides")
    parser.add_argument("--load_path", type=str, default=None,
                        help="trained checkpoint to gate (enables the "
                             "pass/fail exit status)")
    parser.add_argument("--network", type=str, default=None)
    parser.add_argument("--episodes", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-frames", type=int, default=None,
                        help="cap every scenario's per-episode frame "
                             "budget")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    overrides = None
    if args.family:
        from toybox_tpu_torch.sample_tests.families import (FAMILIES,
                                                            model_path,
                                                            overrides_for)

        if args.family not in FAMILIES:
            raise ValueError(f"unknown family {args.family!r}; have "
                             f"{', '.join(FAMILIES)}")
        spec = FAMILIES[args.family]
        args.alg = spec["alg"]
        args.network = args.network or spec["network"]
        args.load_path = args.load_path or model_path(args.family,
                                                      args.game)
        overrides = overrides_for(args.family, args.game)

    gating = args.load_path is not None
    t0 = time.perf_counter()
    if gating:
        from toybox_tpu_torch.regress import full_f32
        from toybox_tpu_torch.rl.eval_adapter import load_eval_params
        from toybox_tpu_torch.run import default_network
        from toybox_tpu_torch.sample_tests.runner import run_all_gated

        full_f32()
        network = args.network or default_network(args.alg)
        state_dict = load_eval_params(args.alg, network, args.load_path,
                                      args.game, args.device).state_dict()

        def report(name, r):
            print(f"  {_line(name, r, gating)} ({r['seconds']:.1f} s)",
                  flush=True)

        results = run_all_gated(
            args.game, state_dict=state_dict, alg=args.alg,
            network=network, episodes=args.episodes,
            seed=args.seed, max_frames=args.max_frames, overrides=overrides,
            device=args.device, on_result=report)
    else:
        from toybox_tpu_torch.sample_tests import run_all

        results = run_all(args.game, episodes=args.episodes, seed=args.seed,
                          max_frames=args.max_frames, device=args.device)
    failed = []
    for name, r in results.items():
        print(_line(name, r, gating))
        if r["passed"] is False:
            failed.append(name)
    where = args.device
    if where.startswith("cuda"):
        import torch

        from toybox_tpu_torch.ops.render_cuda import LAUNCHES
        where = torch.cuda.get_device_name()
        print(f"frame kernel launches: {LAUNCHES}")
    print(f"elapsed: {time.perf_counter() - t0:.1f} s on {where}")

    if gating and failed:
        print(f"BEHAVIORAL REGRESSION ({args.game}): {', '.join(failed)}")
        sys.exit(1)
    if not gating:
        print("(smoke mode — untrained policy, checks not gated)")


if __name__ == "__main__":
    main()

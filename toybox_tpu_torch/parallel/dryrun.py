"""Multi-rank dry runs (port of ``__graft_entry__.dryrun_multichip`` and
``scripts/distributed_smoke.py``).

- ``dryrun_multichip(n)``: one step each of PPO (data-parallel minibatch
  SGD), DQN (the replay ring sharded on its capacity axis) and ACKTR
  (K-FAC's taps all-reduced before the EMA and the inversion), on tiny
  shapes over the process group's ``n`` ranks (``rl.ppo.dryrun``,
  ``rl.dqn.dryrun``, ``rl.acktr.dryrun``).
- The phases (``PHASES``): each runs on this rank's block of a global
  env set over a mesh, or with ``mesh=None`` on the whole set in one
  process, the reference that the ranks' results must equal.
- ``run_ranks``: spawns the ranks of a gloo group as processes of this
  module (a ``FileStore`` rendezvous in a fresh temp dir, so that no port
  is fixed), each under a timeout, and returns what each rank computed.

Run the two-process check (env phase: the global sums and the ranks'
env states equal a single-process run's, which must pass a game over
and its reseeded restart; train phase: the params after
one sharded PPO update within rtol 2e-4, atol 1e-6 of the single-process
update's; the DQN sharded sample's slots equal the single ring's):

    python -m toybox_tpu_torch.parallel.dryrun [--device cuda|cpu]

Two gloo ranks share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

BASE_SEED = 1000
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "toybox_tpu_torch.parallel.dryrun"
#: rtol, atol of a sharded update against the single-process one
PARAM_TOL = (2e-4, 1e-6)


def dryrun_mesh(n_devices: int, sharded: bool):
    """The mesh of a learner's dryrun: the process group's, which must
    hold ``n_devices`` ranks (one rank without a group); None when not
    ``sharded``."""
    from toybox_tpu_torch.parallel.mesh import make_mesh
    if not sharded:
        return None
    mesh = make_mesh()
    if mesh.size != n_devices:
        raise ValueError(f"need {n_devices} ranks, the process group has "
                         f"{mesh.size}")
    return mesh


def dryrun_multichip(n_devices: int, device="cuda",
                     game: str = "breakout") -> dict:
    """One step each of PPO, DQN and ACKTR over a mesh of the process
    group's ``n_devices`` ranks (one rank without a process group);
    returns {alg: (state, metrics)}."""
    from toybox_tpu_torch.rl import acktr, dqn, ppo
    dryrun_mesh(n_devices, True)
    return {name: mod.dryrun(n_devices, game, device=device)
            for name, mod in (("ppo", ppo), ("dqn", dqn),
                              ("acktr", acktr))}


# ---------------------------------------------------------------------------
# The phases: fn(mesh or None, device, opts) -> {name: tensor}
# ---------------------------------------------------------------------------

def _flat(tree, prefix: str = "") -> dict:
    """{dotted name: tensor} of a tree of dataclasses and dicts."""
    if torch.is_tensor(tree):
        return {prefix: tree.detach().cpu()}
    if dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _block(mesh, n_global: int):
    """This rank's block of ``n_global`` envs (all of them without a
    mesh)."""
    from toybox_tpu_torch.parallel.mesh import env_block
    ranks = 1 if mesh is None else mesh.size
    if n_global % ranks:
        raise ValueError(f"{n_global} envs do not split over {ranks} ranks")
    return env_block(mesh, n_global // ranks)


def phase_env(mesh, device, opts) -> dict:
    """``steps`` env steps of a global set of ``envs`` Breakout envs with
    auto-reset, each game of one life (Breakout's first game overs then
    come at steps 105-108), so that the run passes game overs: each
    rank's block reseeds with the whole set's stride, and a game over
    starts the game one process would start. The envs are seeded
    BASE_SEED + global env id, each env's action (t * 7 + id) % A.
    Returns the state of this rank's envs and the rewards, scores and
    game overs summed over every env of every rank."""
    from toybox_tpu_torch.envs.batched import make_batched_env
    from toybox_tpu_torch.games import get_game
    from toybox_tpu_torch.parallel.mesh import all_reduce
    n, game = opts["envs"], opts.get("game", "breakout")
    blk = _block(mesh, n)
    cfg = dataclasses.replace(get_game(game).default_config(device),
                              start_lives=1)
    fns = make_batched_env(game, blk.n_local, config=cfg, obs_mode="none",
                           seed_stride=n)
    ids = torch.arange(blk.lo, blk.lo + blk.n_local, device=device)
    state, _ = fns.reset(BASE_SEED + ids)
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    for t in range(opts["steps"]):
        state, _, rew, done, info = fns.step(state,
                                             (t * 7 + ids) % fns.num_actions)
        sums += torch.stack([rew.sum(), info["score"].sum(),
                             done.sum()]).to(torch.float64)
    sums = all_reduce(sums, mesh)
    out = {f"state.{k}": v for k, v in _flat(state.game).items()}
    out.update(global_sums=sums.cpu(), reward=rew.cpu(), done=done.cpu())
    return out


def phase_train(mesh, device, opts) -> dict:
    """One PPO update (cnn_small, nsteps 4, 2 minibatches, 2 epochs) of a
    global set of ``envs`` envs of ``game``; its params and metrics."""
    from toybox_tpu_torch.envs.pipeline import make_rl_env
    from toybox_tpu_torch.parallel.mesh import replicate
    from toybox_tpu_torch.regress import full_f32
    from toybox_tpu_torch.rl.ppo import make_ppo
    full_f32()
    n = opts["envs"]
    blk = _block(mesh, n)
    env = make_rl_env(opts.get("game", "breakout"), blk.n_local,
                      seed_stride=n, device=device)
    init_fn, train_step, _ = make_ppo(env, nsteps=4, nminibatches=2,
                                      noptepochs=2, network="cnn_small",
                                      total_updates=4, device=device,
                                      mesh=mesh)
    state = init_fn(0)
    replicate(list(state.module.parameters()), mesh)
    state, metrics = train_step(state)
    out = {f"params.{k}": v.detach().cpu()
           for k, v in state.module.state_dict().items()}
    out.update({f"metrics.{k}": v.detach().cpu() for k, v in metrics.items()})
    return out


def phase_learn(mesh, device, opts) -> dict:
    """``ppo.learn`` of two updates (cnn_small, nsteps 4, 2 minibatches,
    one epoch) over ``envs`` envs of ``game`` in all, under ``mesh``; the
    params."""
    from toybox_tpu_torch.rl import ppo
    state = ppo.learn(game=opts.get("game", "breakout"),
                      num_envs=opts["envs"], network="cnn_small", nsteps=4,
                      nminibatches=2, noptepochs=1,
                      total_timesteps=2 * 4 * opts["envs"] * 4, mesh=mesh,
                      device=device)
    return {f"params.{k}": v.detach().cpu()
            for k, v in state.module.state_dict().items()}


def phase_dqn(mesh, device, opts) -> dict:
    """Two DQN cycles (cnn_small, a ring of 2 * ``envs`` slots, batch 8,
    train_freq 2, learning from the start) over a global set of ``envs``
    envs, the ring sharded over the mesh; then one sample with a fresh
    draw. The sampled slots and weights, and the params."""
    from toybox_tpu_torch.envs.pipeline import make_rl_env
    from toybox_tpu_torch.regress import full_f32
    from toybox_tpu_torch.rl import dqn
    from toybox_tpu_torch.rl.distributions import gumbel
    full_f32()
    n = opts["envs"]
    blk = _block(mesh, n)
    env = make_rl_env(opts.get("game", "breakout"), blk.n_local,
                      seed_stride=n, device=device)
    cap = 2 * n
    init_fn, cycle, _ = dqn.make_dqn(
        env, network="cnn_small", buffer_size=cap, batch_size=8,
        train_freq=2, learning_starts=0, total_timesteps=64, device=device,
        mesh=mesh)
    state = init_fn(0)
    out = {}
    for i in range(2):
        state, metrics = cycle(state)
        out[f"metrics{i}.loss"] = metrics["loss"].detach().cpu()
    noise = gumbel((8, cap), torch.Generator(device=device).manual_seed(1),
                   device)
    _, idx, w = dqn.replay_sample(state.replay, noise, 0.6, 0.5,
                                  _block(mesh, cap))
    out.update(idx=idx.cpu(), weights=w.cpu())
    out.update({f"params.{k}": v.detach().cpu()
                for k, v in state.module.state_dict().items()})
    return out


def phase_acktr(mesh, device, opts) -> dict:
    """One ACKTR update (36-pixel frames, fc0 of 32, nsteps 4) of a global
    set of ``envs`` envs: the factors' EMA (the first update's factors
    times 0.01), the params and the metrics."""
    from toybox_tpu_torch.envs.pipeline import make_rl_env
    from toybox_tpu_torch.regress import full_f32
    from toybox_tpu_torch.rl.acktr import make_acktr
    full_f32()
    n = opts["envs"]
    blk = _block(mesh, n)
    env = make_rl_env(opts.get("game", "breakout"), blk.n_local,
                      frame_size=36, seed_stride=n, device=device)
    init_fn, train_step, _ = make_acktr(env, nsteps=4, hidden=32,
                                        invert_every=1, total_updates=1,
                                        device=device, mesh=mesh)
    state, metrics = train_step(init_fn(0))
    out = {f"factors.{k}.{i}": f.detach().cpu()
           for k, v in state.kfac_stats.items() for i, f in enumerate(v)}
    out.update({f"params.{k}": v.detach().cpu()
                for k, v in state.module.state_dict().items()})
    out.update({f"metrics.{k}": v.detach().cpu() for k, v in metrics.items()})
    return out


def phase_moments(mesh, device, opts) -> dict:
    """``mesh_moments`` of arange(``envs``) spread over the ranks."""
    from toybox_tpu_torch.parallel.mesh import mesh_moments
    n = opts["envs"]
    x = _block(mesh, n).take(torch.arange(float(n), device=device))
    m, s, c = mesh_moments(x, mesh)
    return {"moments": torch.stack([m, s, c]).cpu()}


PHASES = {"env": phase_env, "train": phase_train, "learn": phase_learn,
          "dqn": phase_dqn, "acktr": phase_acktr, "moments": phase_moments}


# ---------------------------------------------------------------------------
# Spawning the ranks
# ---------------------------------------------------------------------------

def run_ranks(phases, world: int = 2, device="cuda", timeout: float = 120.0,
              **opts) -> list:
    """Run ``phases`` (names in PHASES) on ``world`` spawned ranks of a
    gloo group, every rank on ``device``; returns each rank's
    {phase: results}. A rank that fails, or that is not done within
    ``timeout`` seconds (the group's own timeout is as long), fails the
    call and every rank is stopped."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        procs, logs = [], []
        try:
            for r in range(world):
                log = open(os.path.join(tmp, f"rank{r}.log"), "w")
                logs.append(log)
                cmd = [sys.executable, "-m", MODULE, "--worker",
                       "--rank", str(r), "--world", str(world),
                       "--store", os.path.join(tmp, "store"),
                       "--out", os.path.join(tmp, f"rank{r}.pt"),
                       "--device", str(device), "--phases", ",".join(phases),
                       "--timeout", str(timeout), "--opts", json.dumps(opts)]
                procs.append(subprocess.Popen(cmd, stdout=log,
                                              stderr=subprocess.STDOUT,
                                              env=env, cwd=ROOT))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the ranks were not done within {timeout} s:"
                               f"\n{_logs(tmp, world)}") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} failed:\n{_logs(tmp, world)}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)]


def _logs(tmp: str, world: int) -> str:
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.log")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"--- rank {r}\n" + f.read()[-4000:])
    return "\n".join(out)


def _worker(args) -> None:
    import torch.distributed as dist

    from toybox_tpu_torch.ops import render_cuda
    from toybox_tpu_torch.parallel.mesh import (initialize_distributed,
                                                make_mesh,
                                                process_seed_offset)
    torch.set_num_threads(1)
    initialize_distributed(f"file://{args.store}", args.world, args.rank,
                           backend="gloo",
                           timeout=datetime.timedelta(seconds=args.timeout))
    try:
        mesh = make_mesh()
        opts = json.loads(args.opts)
        out = {name: PHASES[name](mesh, args.device, opts)
               for name in args.phases.split(",")}
        out["mesh"] = {"shape": dict(mesh.shape), "rank": mesh.rank,
                       "seed_offset": process_seed_offset(100, 64)}
        out["launches"] = dict(render_cuda.LAUNCHES)
        torch.save(out, args.out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The two-process check
# ---------------------------------------------------------------------------

def compare(ranks: list, single: dict) -> dict:
    """Hold the ranks' results (``run_ranks``) against the single-process
    ones (``PHASES`` with mesh None): {check: (ok, detail)}."""
    out = {}
    if "env" in single:
        s = single["env"]
        sums = [r["env"]["global_sums"] for r in ranks]
        out["env_global_sums"] = (
            all(torch.equal(x, s["global_sums"]) for x in sums),
            [float(v) for v in sums[0]])
        same = all(torch.equal(torch.cat([r["env"][k] for r in ranks]), v)
                   for k, v in s.items() if k.startswith("state.")
                   or k in ("reward", "done"))
        out["env_state_bit_equal"] = (same, None)
        out["env_game_over"] = (bool(s["global_sums"][2] > 0),
                                float(s["global_sums"][2]))
    if "train" in single:
        rtol, atol = PARAM_TOL
        worst = 0.0
        ok = True
        for k, v in single["train"].items():
            if not k.startswith("params."):
                continue
            for r in ranks:
                d = (r["train"][k] - v).abs()
                ok &= bool((d <= atol + rtol * v.abs()).all())
                worst = max(worst, float(d.max()))
        out["train_params_close"] = (ok, worst)
    if "dqn" in single:
        out["dqn_sample_idx_equal"] = (
            all(torch.equal(r["dqn"]["idx"], single["dqn"]["idx"])
                for r in ranks), single["dqn"]["idx"].tolist())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--worker", action="store_true")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--store", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--phases", default="env,train,dqn")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--opts", default="{}")
    p.add_argument("--game", default="breakout")
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--steps", type=int, default=128)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args)
        return 0
    opts = dict(game=args.game, envs=args.envs, steps=args.steps)
    phases = args.phases.split(",")
    t0 = time.perf_counter()
    ranks = run_ranks(phases, world=args.world, device=args.device,
                      timeout=args.timeout, **opts)
    t1 = time.perf_counter()
    single = {name: PHASES[name](None, args.device, opts) for name in phases}
    checks = compare(ranks, single)
    ok = all(v[0] for v in checks.values())
    print(json.dumps({"test": "distributed", "backend": "gloo",
                      "device": args.device, "world": args.world, **opts,
                      "ranks_s": round(t1 - t0, 3),
                      "single_s": round(time.perf_counter() - t1, 3),
                      "checks": {k: {"ok": v[0], "detail": v[1]}
                                 for k, v in checks.items()},
                      "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Hold the port's PPO training path on the card against its CPU path, at
the recipe's width, past game overs and over several updates.

    python3 scripts/train_path_vs_cpu.py [--part all|e1|e2] \
        [--envs 1024] [--steps 1000] [--max-steps 2000] [--updates 4] \
        [--out build/train_path]

E1, the training env past game overs: ``make_rl_env("breakout", N,
inkernel_warp=..., seed_stride=N)`` on the card and on the CPU, as
``ppo.learn`` builds it, reset from the env seeds that the CPU's
``make_ppo`` ``init_fn(0)`` draws, and stepped with the same actions for
at least ``--steps`` agent steps, then on until 90 % of the envs have
finished a game (at most ``--max-steps``). Two action scripts: a
numpy-seeded random one with FIRE on 30 % of the steps, and the actions
of ``models/Breakout.regress.model``'s eval head played on the CPU's
observations (the head runs on the card in f32; its logits are sampled
on the CPU with a CPU generator) and handed to both devices. After the
reset and after every step: every engine field, the env's score, return
and length counters and reseed counters, the [N, 4, 84, 84] frame stack,
the pipeline's lives, the rewards, dones and the finished games' return
and length. The stack is held bit for bit on the in-kernel warp and
within 1 grey level on the matmul warp (``--warp matmul``: cuBLAS sums
the warp's matmuls in another order than the CPU); everything else bit
for bit. A game over is counted where an env's reseed counter moves (the
episode statistics show only the games that end on the last of a step's
four frames, in the JAX package too). The four (script, warp) runs go in
processes of their own, all at once, their logs under ``--out``.

E2, the whole train_step over several updates: ``make_ppo`` at the
recipe (N envs x 128 steps, 4 minibatches x 4 epochs, lr and clip
annealed over its 228 updates, full f32, the in-kernel warp) from
``init_fn(0)`` on the CPU, and on the card from the CPU's env seeds and
params, ``--updates`` consecutive ``collect`` + ``optimize`` calls as
``learn`` makes them. The card is fed the CPU's draws: the Gumbel noise
of every rollout step and every epoch's permutation. Where the card's
argmax differs from the CPU's action, the card takes the CPU's action,
and the flip is kept with its margin (the CPU's top two of logits +
noise) and the step's largest logit difference. The yardstick, card':
the card again from the CPU's params scaled by (1 + 1e-7 N(0, 1))
(numpy, seed 0), fed the same draws and actions. After each update: the
largest param difference card - CPU and card - card', both devices'
metrics, whether the rollouts' rewards, dones, finished games, actions,
observations and final engine states are equal, and the flips.

The rule (PERF.md, section 6) classes the run: a fault if E1 finds any
difference beyond the matmul warp's 1 grey level, if E2's card is more
than 1e-5 from the CPU after update 0 or more than twice card - card'
after a later update, if its rollouts differ, or if a flip is not a near
tie (margin above twice the step's largest logit difference). It prints
a line per run and update and, last, one JSON object (also written to
``<out>/result.json``); it exits 1 on a fault.

``--device`` and ``--ref`` name the two devices (cuda and cpu); the CPU
against itself (``--device cpu``) is the harness's own check, which
tests/test_torch_train_path.py runs at a tiny size.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from toybox_tpu_torch.envs.pipeline import make_rl_env  # noqa: E402
from toybox_tpu_torch.games import breakout as bk  # noqa: E402
from toybox_tpu_torch.ops import render_cuda  # noqa: E402
from toybox_tpu_torch.regress import full_f32  # noqa: E402
from toybox_tpu_torch.rl import policies, ppo  # noqa: E402
from toybox_tpu_torch.rl.checkpoint import load_state_dict  # noqa: E402
from toybox_tpu_torch.rl.distributions import CategoricalPd  # noqa: E402
from toybox_tpu_torch.run import alg_defaults  # noqa: E402

MODEL = ROOT / "models" / "Breakout.regress.model"
RECIPE = alg_defaults("ppo")
TOTAL_UPDATES = 120_000_000 // (1024 * 128 * 4)    # the recipe's 228
FIRE_SHARE = 0.3
GAME_OVER_SHARE = 0.9
EPS = 1e-7                   # card': the params' relative perturbation
UPDATE0_ATOL = 1e-5
SCRIPTS, WARPS = ("random", "model"), ("kernel", "matmul")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def breakout_config(device, lives=None):
    """The default config, or one whose games start with ``lives``."""
    cfg = bk.default_config(device)
    if lives is None:
        return cfg
    return bk.config_from_json(dict(bk.config_to_json(cfg),
                                    start_lives=lives), device=device)


def training_env(n: int, warp: str, device, lives=None):
    """``make_rl_env`` as ``ppo.learn`` builds it for ``n`` envs."""
    return make_rl_env("breakout", n, config=breakout_config(device, lives),
                       inkernel_warp=warp == "kernel", seed_stride=n,
                       device=device)


def init_seeds(env_fns, device) -> torch.Tensor:
    """The env seeds that ``make_ppo``'s ``init_fn(0)`` draws on
    ``device``."""
    init_fn, _, _ = ppo.make_ppo(env_fns, device=device, **RECIPE)
    return init_fn(0).env_state.env.seeds


def _launches() -> dict:
    return {k: v for k, v in render_cuda.LAUNCHES.items()
            if k.startswith("breakout")}


# ---------------------------------------------------------------------------
# E1: the training env past game overs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Difference:
    what: str
    step: int          # -1: after the reset
    env: int
    got: list
    want: list


def observed(state, out=None) -> dict:
    """What E1 compares: the pipeline state's engine fields, env counters,
    reseed counters, frame stack and lives, and the step's ``out``
    (reward, done, info) where there is one; each [N, ...]."""
    env = state.env
    seen = {f: getattr(env.game, f) for f in bk.FIELDS}
    seen.update({"env.prev_score": env.prev_score,
                 "env.episode_return": env.episode_return,
                 "env.episode_length": env.episode_length,
                 "seeds": env.seeds, "stack": state.stack,
                 "lives": state.lives})
    if out is not None:
        reward, done, info = out
        seen.update(reward=reward, done=done,
                    episode_return=info["episode_return"],
                    episode_length=info["episode_length"])
    return seen


def first_difference(got: dict, want: dict, step: int, grey: int):
    """(the first entry of ``got`` that differs from ``want``'s, or None;
    the frame stacks' largest grey-level difference). Stacks may differ
    by ``grey``; floats are equal where both are NaN."""
    worst = 0
    for name, w in want.items():
        g = got[name].to(w.device)
        if name == "stack":
            if not torch.equal(g, w):
                d = (g.int() - w.int()).abs()
                worst = int(d.max())
                bad = d > grey
            else:
                bad = torch.zeros_like(w, dtype=torch.bool)
        elif w.is_floating_point():
            bad = ~((g == w) | (g.isnan() & w.isnan()))
        else:
            bad = g != w
        if bool(bad.any()):
            env = int(bad.reshape(bad.shape[0], -1).any(1).nonzero()[0, 0])
            return Difference(name, step, env, g[env].flatten()[:8].tolist(),
                              w[env].flatten()[:8].tolist()), worst
    return None, worst


def action_script(kind: str, env_fns, device, ref, seed: int = 0):
    """fn(reference pipeline state) -> actions [N] on ``ref``: the
    random script, or the regress model's eval head."""
    n, n_act = env_fns.num_envs, env_fns.num_actions
    if kind == "random":
        rng = np.random.default_rng(seed)

        def pick(state):
            a = rng.integers(0, n_act, n)
            a[rng.random(n) < FIRE_SHARE] = 1            # FIRE serves
            return torch.as_tensor(a)

        return pick
    module, _ = policies.build_eval_policy("ppo", env_fns.obs_shape, n_act,
                                           "cnn", device=device)
    module.load_state_dict(load_state_dict(MODEL))
    gen = torch.Generator(device=ref)
    gen.manual_seed(seed)

    @torch.no_grad()
    def pick(state):
        logits, _ = module(state.frames.to(device))
        return CategoricalPd(logits.to(ref)).sample(gen)

    return pick


def e1(actions: str = "random", warp: str = "kernel", n: int = 1024,
       steps: int = 1000, max_steps: int | None = None, device="cuda",
       ref="cpu", lives=None, log=print) -> dict:
    """One E1 run (module docstring); stops at the first difference.
    ``lives`` starts every game with that many lives (a shorter run's
    game overs)."""
    full_f32()
    devices = (device, ref)
    envs = [training_env(n, warp, d, lives) for d in devices]
    seeds = init_seeds(envs[1], ref)
    states = [env.reset(seeds.to(d))[0] for env, d in zip(envs, devices)]
    tol = 0 if warp == "kernel" else 1
    diff, grey = first_difference(observed(states[0]), observed(states[1]),
                                  -1, tol)
    pick = action_script(actions, envs[1], device, ref)
    before = _launches()
    games = torch.zeros(n, dtype=torch.int64)
    life_losses, top_score, step = 0, 0, 0
    limit = max(steps, max_steps or steps)
    t0 = time.perf_counter()
    while diff is None and step < limit and (
            step < steps or float((games > 0).float().mean())
            < GAME_OVER_SHARE):
        a = pick(states[1])
        reseeds = states[1].env.seeds
        seen = []
        for i, (env, d) in enumerate(zip(envs, devices)):
            states[i], _, reward, done, info = env.step(states[i], a.to(d))
            seen.append(observed(states[i], (reward, done, info)))
        games += (states[1].env.seeds != reseeds).to(games.device)
        life_losses += int(seen[1]["done"].sum())
        top_score = max(top_score, int(states[1].env.game.score.max()))
        diff, worst = first_difference(seen[0], seen[1], step, tol)
        grey = max(grey, worst)
        step += 1
        if step % 100 == 0:
            log(f"  e1 {actions}/{warp}: step {step}, envs with a game over "
                f"{float((games > 0).float().mean()):.3f}, grey {grey}, "
                f"{time.perf_counter() - t0:.0f} s")
    launches = {k: v - before[k] for k, v in _launches().items()}
    return dict(
        actions=actions, warp=warp, envs=n, steps=step,
        seconds=time.perf_counter() - t0, grey_tolerance=tol, grey_max=grey,
        game_overs=int(games.sum()),
        share_with_game_over=float((games > 0).float().mean()),
        games_per_env=dict(min=int(games.min()), mean=float(
            games.float().mean()), max=int(games.max())),
        life_losses=life_losses, top_score=top_score, launches=launches,
        first_difference=None if diff is None else dataclasses.asdict(diff))


def e1_all(args, log=print) -> list:
    """The four E1 runs, each in a process of its own, all at once."""
    jobs = [(a, w) for a in SCRIPTS for w in WARPS]
    threads = max(1, len(os.sched_getaffinity(0)) // len(jobs))
    log(f"E1: {len(jobs)} runs at once, {threads} CPU threads each")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for a, w in jobs:
            with open(out / f"e1_{a}_{w}.log", "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--part", "e1-one",
                     "--actions", a, "--warp", w, "--threads", str(threads),
                     "--envs", str(args.envs), "--steps", str(args.steps),
                     "--max-steps", str(args.max_steps), "--device",
                     args.device, "--ref", args.ref],
                    stdout=f, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for (a, w), p in zip(jobs, procs):
        lines = (out / f"e1_{a}_{w}.log").read_text().strip().splitlines()
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"E1 {a}/{w} exited {p.returncode}: "
                               + "\n".join(lines[-20:]))
        results.append(json.loads(lines[-1]))
        log(f"E1 {_e1_line(results[-1])}")
    return results


def _e1_line(r: dict) -> str:
    return (f"{r['actions']}/{r['warp']} warp: {r['envs']} envs x "
            f"{r['steps']} agent steps in {r['seconds']:.0f} s; "
            f"{r['game_overs']} game overs, envs with one "
            f"{r['share_with_game_over']:.3f}, games an env "
            f"{r['games_per_env']}, {r['life_losses']} lives lost, top score "
            f"{r['top_score']}; stack grey max {r['grey_max']} (tolerance "
            f"{r['grey_tolerance']}); first difference "
            f"{r['first_difference']}; launches {r['launches']}")


# ---------------------------------------------------------------------------
# E2: the whole train_step over several updates
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Flip:
    update: int
    step: int
    env: int
    margin: float      # the reference's top two of logits + noise
    difference: float  # the step's largest logit difference

    @property
    def near_tie(self) -> bool:
        return self.margin <= 2 * self.difference


@contextlib.contextmanager
def _patched(gumbel, gumbel_max, randperm):
    saved = policies.gumbel, policies.gumbel_max, torch.randperm
    policies.gumbel, policies.gumbel_max, torch.randperm = (
        gumbel, gumbel_max, randperm)
    try:
        yield
    finally:
        policies.gumbel, policies.gumbel_max, torch.randperm = saved


class Draws:
    """One update's random draws (the Gumbel noise of ``noise_step``, the
    epoch permutations of ``optimize``), recorded on the reference run
    and replayed on the others, with the reference's actions and logits.
    ``policies.gumbel``, ``policies.gumbel_max`` and ``torch.randperm``
    are replaced only inside ``record`` and ``replay``."""

    def __init__(self):
        self.noise, self.logits, self.actions, self.perms = [], [], [], []

    @contextlib.contextmanager
    def record(self):
        gumbel, gumbel_max, randperm = (policies.gumbel, policies.gumbel_max,
                                        torch.randperm)

        def noise(*args, **kw):
            g = gumbel(*args, **kw)
            self.noise.append(g.cpu())
            return g

        def act(logits, g):
            a = gumbel_max(logits, g)
            self.logits.append(logits.cpu())
            self.actions.append(a.cpu())
            return a

        def perm(*args, **kw):
            p = randperm(*args, **kw)
            self.perms.append(p.cpu())
            return p

        with _patched(noise, act, perm):
            yield

    @contextlib.contextmanager
    def replay(self, flips: list, update: int):
        """The recorded draws; the recorded action wherever this run's
        argmax differs, each such flip appended to ``flips``."""
        gumbel_max = policies.gumbel_max
        noise_at, perm_at = iter(self.noise), iter(self.perms)
        steps = iter(range(len(self.actions)))

        def noise(shape, generator, device, dtype=torch.float32):
            return next(noise_at).to(device)

        def act(logits, g):
            t = next(steps)
            want, ref_logits = self.actions[t], self.logits[t]
            wrong = (gumbel_max(logits, g).cpu() != want).nonzero()[:, 0]
            if len(wrong):
                diff = float((logits.cpu() - ref_logits).abs().max())
                for e in wrong.tolist():
                    top = torch.sort(ref_logits[e] + self.noise[t][e]).values
                    flips.append(Flip(update, t, e,
                                      float(top[-1] - top[-2]), diff))
            return want.to(logits.device)

        def perm(n, *args, device=None, **kw):
            p = next(perm_at)
            if len(p) != n:
                raise ValueError(f"replayed a permutation of {len(p)} "
                                 f"for one of {n}")
            return p.to(device)

        with _patched(noise, act, perm):
            yield


def perturbed(params: dict, eps: float) -> dict:
    """``params`` scaled by (1 + eps N(0, 1)), numpy seed 0."""
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy((v.cpu().double().numpy() * (
        1 + eps * rng.standard_normal(tuple(v.shape)))).astype(np.float32))
        for k, v in params.items()}


def distance(a: torch.nn.Module, b: torch.nn.Module) -> float:
    sb = b.state_dict()
    return max(float((v.cpu() - sb[k].cpu()).abs().max())
               for k, v in a.state_dict().items())


def compare_rollouts(buf, ref_buf, env_state, ref_env_state) -> dict:
    """A rollout against the reference's: rewards, dones, finished
    games, actions and the final engine state equal or not; the
    observations' largest grey-level difference; the values' largest
    difference."""
    def same(a, b):
        a = a.cpu()
        return bool(((a == b) | (a.isnan() & b.isnan())).all()) \
            if b.is_floating_point() else torch.equal(a, b)

    grey = max(int((buf.obs[t].cpu().int() - ref_buf.obs[t].int())
                   .abs().max()) for t in range(ref_buf.obs.shape[0]))
    engine = all(same(getattr(env_state.game, f),
                      getattr(ref_env_state.game, f)) for f in bk.FIELDS) \
        and same(env_state.seeds, ref_env_state.seeds)
    return dict(
        rewards=same(buf.rewards, ref_buf.rewards),
        dones=same(buf.dones, ref_buf.dones),
        games=same(buf.ep_ret, ref_buf.ep_ret)
        and same(buf.ep_len, ref_buf.ep_len),
        actions=same(buf.actions, ref_buf.actions), engine=engine,
        grey_max=grey, value_diff=float((buf.values.cpu() - ref_buf.values)
                                        .abs().max()))


@dataclasses.dataclass
class _Run:
    state: ppo.PPOState
    step: ppo.TrainStep
    flips: list = dataclasses.field(default_factory=list)
    collected: tuple = None


def e2(n: int = 1024, nsteps: int = 128, updates: int = 4, device="cuda",
       ref="cpu", log=print) -> dict:
    """The E2 runs (module docstring): a dict with a row after each
    update."""
    full_f32()
    kw = dict(RECIPE, nsteps=nsteps)

    def trainer(env_fns, d):
        init_fn, train_step, _ = ppo.make_ppo(
            env_fns, device=d, total_updates=TOTAL_UPDATES, **kw)
        return _Run(init_fn(0), train_step)

    ref_env = training_env(n, "kernel", ref)
    env = training_env(n, "kernel", device)
    base = trainer(ref_env, ref)
    seeds = base.state.env_state.env.seeds
    params = base.state.module.state_dict()
    runs = {}
    for name, eps in (("card", 0.0), ("card'", EPS)):
        run = runs[name] = trainer(env, device)
        run.state.module.load_state_dict(params if not eps
                                         else perturbed(params, eps))
        run.state.env_state, _ = env.reset(seeds.to(device))
    before = _launches()
    rows = []
    for k in range(updates):
        draws, row, t0 = Draws(), dict(update=k), time.perf_counter()
        with draws.record():
            base.collected = base.step.collect(base.state)
        t1 = time.perf_counter()
        for name, run in runs.items():
            with draws.replay(run.flips, k):
                run.collected = run.step.collect(run.state)
            row[f"{name} rollout"] = compare_rollouts(
                run.collected[1], base.collected[1], run.state.env_state.env,
                base.state.env_state.env)
        t2 = time.perf_counter()
        with draws.record():
            base.state, m = base.step.optimize(base.state, base.collected)
        row["metrics ref"] = {k_: float(v) for k_, v in m.items()}
        t3 = time.perf_counter()
        for name, run in runs.items():
            with draws.replay(run.flips, k):
                run.state, m = run.step.optimize(run.state, run.collected)
            row[f"metrics {name}"] = {k_: float(v) for k_, v in m.items()}
        t4 = time.perf_counter()
        row.update(
            card_vs_ref=distance(runs["card"].state.module, base.state.module),
            card_vs_card_=distance(runs["card"].state.module,
                                   runs["card'"].state.module),
            flips=[dataclasses.asdict(f) for f in runs["card"].flips
                   if f.update == k],
            flips_card_=[dataclasses.asdict(f) for f in runs["card'"].flips
                         if f.update == k],
            seconds=dict(ref_collect=t1 - t0, card_collects=t2 - t1,
                         ref_optimize=t3 - t2, card_optimizes=t4 - t3))
        rows.append(row)
        log(f"E2 {_e2_line(row)}")
    return dict(envs=n, nsteps=nsteps, updates=updates, rows=rows,
                launches={k: v - before[k] for k, v in _launches().items()})


def _e2_line(row: dict) -> str:
    r = row["card rollout"]
    flips = row["flips"]
    return (f"update {row['update']}: card-ref {row['card_vs_ref']:.3g}, "
            f"card-card' {row['card_vs_card_']:.3g}; rollout rewards "
            f"{r['rewards']}, dones {r['dones']}, games {r['games']}, "
            f"actions {r['actions']}, engine {r['engine']}, obs grey max "
            f"{r['grey_max']}, values max diff {r['value_diff']:.3g}; "
            f"{len(flips)} flips (largest margin "
            f"{max((f['margin'] for f in flips), default=0):.3g}), card' "
            f"{len(row['flips_card_'])}; metrics ref "
            + ", ".join(f"{k} {v:.6g}" for k, v in row["metrics ref"].items())
            + "; card " + ", ".join(f"{k} {v:.6g}" for k, v in
                                    row["metrics card"].items())
            + "; seconds " + ", ".join(f"{k} {v:.1f}" for k, v in
                                       row["seconds"].items()))


# ---------------------------------------------------------------------------
# E2's update 0, taken apart
# ---------------------------------------------------------------------------

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
WEAK_GRAD = 1e-3


def update0(n: int = 1024, nsteps: int = 128, device="cuda", ref="cpu",
            log=print) -> dict:
    """E2's first update from one batch (collected on ``ref`` from
    ``init_fn(0)``), one set of params and one set of permutations on
    both devices, taken apart. First the first minibatch's loss and
    gradients, as ``ppo.update`` takes them: a semantic fault (a term,
    an op or a precision that differs) would show there, and the rule
    calls it one where the losses are more than LOSS_RTOL apart
    (relative) or a gradient tensor more than GRAD_RTOL of its largest
    entry. Then the whole update (16 Adam steps) on ``ref``, on
    ``device``, on ``device`` again and on ``ref`` at half its threads
    (the same CPU sums in another order): each pair's largest param
    difference, over all weights and split between the weights whose
    first gradient exceeds WEAK_GRAD of its tensor's largest ("strong")
    and the rest ("weak")."""
    full_f32()
    kw = dict(RECIPE, nsteps=nsteps)
    env = training_env(n, "kernel", ref)
    init_fn, train_step, _ = ppo.make_ppo(
        env, device=ref, total_updates=TOTAL_UPDATES, **kw)
    state = init_fn(0)
    params = {k: v.clone() for k, v in state.module.state_dict().items()}
    batch, _ = train_step.collect(state)
    nbatch = batch[0].shape[0]
    gen = torch.Generator()
    gen.manual_seed(0)
    perms = [torch.randperm(nbatch, generator=gen)
             for _ in range(kw["noptepochs"])]
    lrnow, cliprnow = ppo.anneal(0, TOTAL_UPDATES, kw["lr"], kw["cliprange"])
    hp = ppo.Hyper(nminibatches=kw["nminibatches"], ent_coef=kw["ent_coef"])
    mbsize = nbatch // hp.nminibatches

    def module_on(d):
        module = policies.build_policy(env.obs_shape, env.num_actions,
                                       kw["network"], device=d)[0]
        module.load_state_dict(params)
        return module

    def first_minibatch(d):
        module = module_on(d)
        idx = perms[0][:mbsize]
        mb = tuple(x[idx].to(d) for x in batch)
        mb = mb[:-1] + (ppo.normalize(mb[-1]),)
        loss, _ = ppo.ppo_loss(module, mb, cliprnow, hp.ent_coef,
                               hp.vf_coef, env.num_actions,
                               normalize_adv=False,
                               mean=lambda x: x.sum() / mbsize)
        grads = torch.autograd.grad(loss, list(module.parameters()))
        return float(loss.detach()), [g.cpu() for g in grads]

    def whole(d, threads=0):
        module = module_on(d)
        saved = torch.get_num_threads()
        torch.set_num_threads(threads or saved)
        try:
            ppo.update(module, ppo.AdamState.zeros_like(
                list(module.parameters())), tuple(x.to(d) for x in batch),
                [p.to(d) for p in perms], lrnow, cliprnow, hp,
                env.num_actions)
        finally:
            torch.set_num_threads(saved)
        return {k: v.cpu() for k, v in module.state_dict().items()}

    t0 = time.perf_counter()
    loss, grads = {}, {}
    for name, d in (("ref", ref), ("card", device), ("card again", device)):
        loss[name], grads[name] = first_minibatch(d)
    names = [k for k, _ in module_on(ref).named_parameters()]
    strong = {k: g.abs() > WEAK_GRAD * g.abs().max()
              for k, g in zip(names, grads["ref"])}

    def grad_rel(a, b):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(grads[a], grads[b]))

    half = max(1, torch.get_num_threads() // 2)
    after = {"ref": whole(ref), "card": whole(device),
             "card again": whole(device), "ref, half the threads":
             whole(ref, half)}

    def apart(a, b):
        d = {k: (after[a][k] - after[b][k]).abs() for k in params}

        def worst(keep):
            return max((float(v[keep(k)].max()) for k, v in d.items()
                        if bool(keep(k).any())), default=0.0)

        return dict(all=worst(lambda k: torch.ones_like(strong[k])),
                    strong=worst(lambda k: strong[k]),
                    weak=worst(lambda k: ~strong[k]))

    r = dict(
        envs=n, nsteps=nsteps, threads=torch.get_num_threads(),
        half_threads=half,
        loss=loss, loss_rel={k: abs(loss[k] - loss["ref"]) / abs(loss["ref"])
                             for k in ("card", "card again")},
        grad_rel={"card": grad_rel("card", "ref"),
                  "card again": grad_rel("card again", "card")},
        weak_share=sum(int((~v).sum()) for v in strong.values())
        / sum(v.numel() for v in strong.values()),
        moved=max(float((after["ref"][k] - params[k]).abs().max())
                  for k in params),
        update={"card - ref": apart("card", "ref"),
                "card - card again": apart("card", "card again"),
                "ref - ref at half the threads":
                apart("ref", "ref, half the threads")},
        seconds=time.perf_counter() - t0)
    r["fault"] = (max(r["loss_rel"].values()) > LOSS_RTOL
                  or r["grad_rel"]["card"] > GRAD_RTOL)
    log(f"update 0 taken apart: first minibatch loss {loss['ref']:.9g} "
        f"(card {loss['card']:.9g}), relative {r['loss_rel']}; gradients "
        f"apart (of each tensor's largest) {r['grad_rel']}; weak weights "
        f"{r['weak_share']:.3f}; the whole update moved {r['moved']:.3g}, "
        f"apart {r['update']}; {r['seconds']:.0f} s")
    return r


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

def faults(e1_runs: list, e2_run: dict | None,
           yardstick: bool = True) -> list:
    """Every breach of the rule (module docstring); empty: not a fault.
    Without ``yardstick`` the updates after the first are not held to
    card - card'."""
    found = [f"E1 {r['actions']}/{r['warp']}: {r['first_difference']}"
             for r in e1_runs if r["first_difference"] is not None]
    for row in (e2_run or {}).get("rows", []):
        k, d = row["update"], row["card_vs_ref"]
        rollout = row["card rollout"]
        if not all(rollout[key] for key in ("rewards", "dones", "games",
                                            "actions", "engine")) \
                or rollout["grey_max"]:
            found.append(f"E2 update {k}: the rollouts differ: {rollout}")
        if k == 0 and d > UPDATE0_ATOL:
            found.append(f"E2 update 0: card-ref {d:.3g} > {UPDATE0_ATOL:g}")
        if yardstick and k > 0 and d > 2 * row["card_vs_card_"]:
            found.append(f"E2 update {k}: card-ref {d:.3g} > twice "
                         f"card-card' {row['card_vs_card_']:.3g}")
        found += [f"E2 update {k}: a flip that is not a near tie: {f}"
                  for f in row["flips"]
                  if f["margin"] > 2 * f["difference"]]
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--part", choices=("all", "e1", "e2", "e1-one",
                                      "update0"),
                   default="all")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ref", default="cpu")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=1000,
                   help="E1: the least agent steps")
    p.add_argument("--max-steps", type=int, default=2000,
                   help="E1: the most agent steps")
    p.add_argument("--actions", choices=SCRIPTS, default="random",
                   help="E1, one run (--part e1-one): the action script")
    p.add_argument("--warp", choices=WARPS, default="kernel",
                   help="E1, one run: the in-kernel or the matmul warp")
    p.add_argument("--nsteps", type=int, default=RECIPE["nsteps"])
    p.add_argument("--updates", type=int, default=4)
    p.add_argument("--threads", type=int, default=0,
                   help="torch's CPU threads (0: its default)")
    p.add_argument("--out", default="build/train_path")
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("train_path_vs_cpu: no CUDA device", file=sys.stderr)
        return 2
    if args.part == "e1-one":
        print(json.dumps(e1(args.actions, args.warp, args.envs, args.steps,
                            args.max_steps, args.device, args.ref,
                            log=lambda s: print(s, flush=True))))
        return 0
    on_card = args.device.startswith("cuda")
    head = dict(card=card() if on_card else None,
                kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                device=args.device, ref=args.ref)
    print(head["card"] or f"{args.device} against {args.ref}", flush=True)

    def log(s):
        print(s, flush=True)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.part == "update0":
        r = dict(head, **update0(args.envs, args.nsteps, args.device,
                                 args.ref, log))
        (out / "update0.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r))
        return 1 if r["fault"] else 0
    t0 = time.perf_counter()
    e1_runs = e1_all(args, log) if args.part in ("all", "e1") else []
    t1 = time.perf_counter()
    e2_run = e2(args.envs, args.nsteps, args.updates, args.device, args.ref,
                log) if args.part in ("all", "e2") else None
    t2 = time.perf_counter()
    found = faults(e1_runs, e2_run)
    result = dict(head, e1=e1_runs, e2=e2_run, e1_seconds=t1 - t0,
                  e2_seconds=t2 - t1, faults=found,
                  verdict="fault" if found else "not a fault of the port")
    (out / "result.json").write_text(json.dumps(result, indent=1))
    log(f"E1 {t1 - t0:.0f} s, E2 {t2 - t1:.0f} s; verdict: "
        f"{result['verdict']}" + "".join(f"\n  {f}" for f in found))
    print(json.dumps(result))
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())

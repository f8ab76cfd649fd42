#!/usr/bin/env python3
"""One behavioral-gate play of a model family through the JAX package and
the port side by side on the CPU, with the same Gumbel noise, to tell a
port fault from chance when the port's gate and the JAX package's differ.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/gate_vs_jax.py \
        space_invaders ppo1 NoShields [--episodes 5] [--seed 0]

Both packages capture the scenario's set-up, start every episode from it
by ``reset_to`` (the gate's seeds), and draw ``argmax(logits + g)`` with
JAX's noise ``g`` (the key schedule of the JAX runner). Where the two
policies' logits (which see observations up to 1 grey level apart, the
warps summing in other orders) pick different actions, the step is
listed with its margin between the top two ``logits + g`` and the
largest logit difference, and both take JAX's action, so that the
episodes go on together. Raw rewards and dones must stay equal at every
step. It prints each episode's raw score, as the gate scores it (the
scenario's frame budget in whole chunks of 128 agent steps), and the
steps where the actions differed: a difference that is not a near tie
(margin above twice the logit difference) would be a fault. Needs the
JAX package and a feed-forward pi + V family (ppo, ppo1, a2c, gail, bc,
trpo).
"""

from __future__ import annotations

import argparse
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

import toybox_tpu.sample_tests as j_st
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.games import get_game as j_get_game
from toybox_tpu.rl.eval_adapter import load_eval_params as j_load
from toybox_tpu.rl.policies import build_policy as j_build_policy
from toybox_tpu.sample_tests.families import FAMILIES, model_path
from toybox_tpu.sample_tests.runner import capture_setup
from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.games import get_game
from toybox_tpu_torch.rl.distributions import gumbel_max
from toybox_tpu_torch.rl.eval_adapter import load_eval_params

CHUNK = 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("game")
    ap.add_argument("family")
    ap.add_argument("scenario")
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    spec = FAMILIES[args.family]
    path = model_path(args.family, args.game)
    n, seed = args.episodes, args.seed
    scenario = {c.__name__: c for c in j_st.get_scenarios(args.game)}[
        args.scenario](seed=seed)
    cfg_js, st_js = capture_setup(scenario)
    jm, tm = j_get_game(args.game), get_game(args.game)
    jcfg, tcfg = jm.config_from_json(cfg_js), tm.config_from_json(cfg_js,
                                                                  "cpu")
    kw = dict(episodic_life=False, clip_rewards=False)
    jenv = j_make_rl_env(args.game, n, config=jcfg, **kw)
    tenv = make_rl_env(args.game, n, config=tcfg, device="cpu", **kw)
    seeds = np.arange(n) + seed
    jst, _ = jax.jit(partial(jenv.reset_to, reseed=True))(
        jm.state_from_json(jcfg, st_js), jnp.asarray(seeds, jnp.uint32))
    tst, _ = tenv.reset_to(tm.state_from_json(tcfg, st_js),
                           torch.as_tensor(seeds), reseed=True)
    jmod = j_build_policy(jenv.obs_shape, jenv.num_actions,
                          spec["network"])[0]
    params = j_load(spec["alg"], spec["network"], path, args.game)
    head = load_eval_params(spec["alg"], spec["network"], path, args.game,
                            device="cpu")
    j_logits = jax.jit(lambda p, o: jmod.apply(p, o)[0])
    j_step = jax.jit(jenv.step)

    key = jax.random.PRNGKey(seed)
    totals, finished = np.zeros(n), np.zeros(n, bool)
    differ, worst = [], 0.0
    chunks = max(scenario.max_frames // jenv.frames_per_step // CHUNK, 1)
    steps = chunks * CHUNK
    for i in range(steps):
        key, akey = jax.random.split(key)
        jl = j_logits(params, jst.frames)
        g = jax.random.gumbel(akey, jl.shape, jnp.float32)
        ja = np.array(jnp.argmax(jl + g, -1))
        with torch.no_grad():
            tl = head(tst.frames)[0]
        ta = gumbel_max(tl, torch.as_tensor(np.array(g))).numpy()
        diff = float(np.abs(np.asarray(jl) - tl.numpy()).max())
        worst = max(worst, diff)
        if not np.array_equal(ja, ta):
            z = np.sort(np.asarray(jl + g), -1)
            e = int(np.argmax(ja != ta))
            differ.append((i, e, float(z[e, -1] - z[e, -2]), diff))
        jst, _, _, jd, ji = j_step(jst, jnp.asarray(ja))
        tst, _, _, td, ti = tenv.step(tst, torch.as_tensor(ja))
        r = np.asarray(ji["raw_reward"])
        if not (np.array_equal(ti["raw_reward"].numpy(), r)
                and np.array_equal(td.numpy(), np.asarray(jd))):
            print(f"FAULT: rewards or dones differ at agent step {i}")
            return 1
        totals += np.where(finished, 0.0, r)
        finished |= np.asarray(jd)
        if finished.all() and i % CHUNK == CHUNK - 1:
            break
    print(f"{args.family} {args.game} {args.scenario} seed {seed}: "
          f"{i + 1} agent steps, episode scores {totals.tolist()}")
    print(f"largest logit difference {worst:.3g}; actions differed at "
          f"{len(differ)} steps (step, env, margin, logit difference):")
    for i, e, margin, diff in differ:
        tie = "near tie" if margin <= 2 * diff else "NOT A NEAR TIE"
        print(f"  {i} env {e}: {margin:.3g}, {diff:.3g} ({tie})")
    return 0 if all(m <= 2 * d for _, _, m, d in differ) else 1


if __name__ == "__main__":
    raise SystemExit(main())

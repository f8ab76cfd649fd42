#!/usr/bin/env python3
"""A gate's play through the JAX package and the port side by side, in
lock-step with JAX's random draws, to tell a port fault from chance when
the port's gate result and the JAX package's differ.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/gate_vs_jax.py \
        space_invaders ppo1 NoShields [--episodes 5] [--seed 0]
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/gate_vs_jax.py \
        breakout acer control                  # the gate's control play
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/gate_vs_jax.py \
        breakout models/Breakout.ppo_lstm.model EZChannel  # any checkpoint
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/gate_vs_jax.py \
        --regress models/Breakout.acer.model [--seed 0] [--record F.npz]
    PYTHONPATH=. python scripts/gate_vs_jax.py --replay F.npz --device cuda

Scenario mode plays one scenario of the behavioral gate (a model family
of ``sample_tests.families``, or a checkpoint file): each package captures
the scenario's set-up through its own intervention API and starts every
episode from it by ``reset_to`` (the gate's seeds); ``control`` plays the
unmodified game at the budget of the game's first scenario that needs a
control (the control the gate prints). ``--regress`` plays the regress
gate of one checkpoint as ``toybox_tpu.regress.play_games`` does: env
seeds ``arange(10) + seed``, the score cap, the finish checked every
chunk of 128 agent steps. The JAX package plays on the CPU.

Every step both heads see their own stack's observation, and JAX draws
as ``toybox_tpu.rl.policies`` draws from ``key, akey = split(key)``:

- a categorical head (pi + V, acer's pi beside its Q head, acktr's K-FAC
  net, and the recurrent heads) samples ``argmax(logits + g)``, ``g =
  gumbel(akey)``; the port takes ``argmax(its logits + g)``;
- deepq's head explores where ``uniform(ekey) < 0.01`` with
  ``randint(akey')`` (``ekey, akey' = split(akey)``), else takes the
  greedy Q; the port takes the same explore mask and random action, else
  its own greedy Q;
- a recurrent head threads its own carry in each stack, reset by the
  previous step's dones.

Where the two heads (which see observations up to 1 grey level apart,
the warps summing in other orders) pick different actions, the step is
listed with its margin (between the top two ``logits + g``, or the top
two Q values) and the largest logit (or Q) difference of the two heads,
and both take JAX's action, so that the games go on together. Raw
rewards and dones must stay equal at every step. A flip is a near tie
when its margin is at most twice the difference (the least difference
that can reorder the two); any other flip would be a fault, and the run
exits 1. It prints each game's raw score, as the gate scores it.

``--record`` writes JAX's side of the play (its draws, actions, logits or
Q values, raw rewards and dones) to an ``.npz``; ``--replay`` plays the
port alone against such a file on any device (the card machine has no
JAX), with the same checks: the port's whole path on the card held to
JAX's play.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os

import numpy as np
import torch

from toybox_tpu_torch.core.actions import LEGAL_ACTIONS
from toybox_tpu_torch.envs.pipeline import make_rl_env
from toybox_tpu_torch.games import get_game
from toybox_tpu_torch.regress import (DEFAULT_GAMES, MAX_FRAMES, SCORE_CAP,
                                      full_f32)
from toybox_tpu_torch.rl.distributions import gumbel_max
from toybox_tpu_torch.rl.eval_adapter import checkpoint_head, \
    load_eval_params
from toybox_tpu_torch.rl.models import RECURRENT_NETWORKS
from toybox_tpu_torch.sample_tests import get_scenarios
from toybox_tpu_torch.sample_tests.families import (FAMILIES, GAME_PREFIX,
                                                    model_path)
from toybox_tpu_torch.sample_tests.runner import capture_setup

CHUNK = 128
NLSTM = 128
EPS = 0.01                       # deepq's eval exploration
Q_ALGS = ("deepq", "dqn")
GAMES = {prefix: game for game, prefix in GAME_PREFIX.items()}


def near_tie(margin: float, diff: float) -> bool:
    """A flip that a head difference of ``diff`` can explain: the top two
    lie within twice the largest difference of the two heads."""
    return margin <= 2 * diff


@dataclasses.dataclass
class Flip:
    step: int
    env: int
    margin: float
    diff: float


@dataclasses.dataclass
class Play:
    steps: int
    totals: np.ndarray
    flips: list
    worst: float
    fault: str | None = None

    @property
    def chance(self) -> bool:
        return self.fault is None and all(near_tie(f.margin, f.diff)
                                          for f in self.flips)


@dataclasses.dataclass
class Cell:
    """One gate play: the game, the head, the start and the length.
    ``scenario`` is None for the regress gate, else a scenario's name or
    ``control``; ``cap`` is the regress gate's score cap."""
    game: str
    alg: str
    network: str
    path: str
    n: int
    seed: int
    steps: int
    scenario: str | None = None
    cap: float | None = None


def regress_cell(path: str, seed: int = 0, n: int = DEFAULT_GAMES,
                 steps: int = MAX_FRAMES // 4 // CHUNK * CHUNK) -> Cell:
    """The regress gate of checkpoint ``path`` (``n`` games, at most
    ``steps`` agent steps)."""
    game = GAMES[os.path.basename(path).split(".")[0]]
    return Cell(game, *checkpoint_head(path), path, n, seed, steps,
                cap=SCORE_CAP)


def _scenario(game: str, name: str, seed: int):
    """The port's scenario ``name`` of ``game`` (for ``control``, the
    first scenario that needs a control)."""
    classes = get_scenarios(game)
    if name == "control":
        return next(c for c in classes
                    if getattr(c, "needs_control", False))(seed=seed)
    return {c.__name__: c for c in classes}[name](seed=seed)


def scenario_cell(game: str, family: str, name: str, seed: int = 0,
                  episodes: int | None = None) -> Cell:
    """One scenario (or ``control``) of the behavioral gate of a model
    family or a checkpoint file."""
    if family in FAMILIES:
        alg, network = FAMILIES[family]["alg"], FAMILIES[family]["network"]
        path = model_path(family, game)
    else:
        (alg, network), path = checkpoint_head(family), family
    s = _scenario(game, name, seed)
    chunks = max(s.max_frames // 4 // CHUNK, 1)
    return Cell(game, alg, network, path, episodes or s.n_episodes, seed,
                chunks * CHUNK, scenario=name)


def port_start(cell: Cell, device) -> tuple:
    """The port's env and first state of a cell on ``device``."""
    kw = dict(episodic_life=False, clip_rewards=False, device=device)
    seeds = torch.arange(cell.n, device=device) + cell.seed
    if cell.scenario in (None, "control"):
        env = make_rl_env(cell.game, cell.n, **kw)
        return env, env.reset(seeds)[0]
    tm = get_game(cell.game)
    cfg_js, st_js = capture_setup(_scenario(cell.game, cell.scenario,
                                            cell.seed), device)
    cfg = tm.config_from_json(cfg_js, device)
    env = make_rl_env(cell.game, cell.n, config=cfg, **kw)
    return env, env.reset_to(tm.state_from_json(cfg, st_js), seeds,
                             reseed=True)[0]


class PortHead:
    """The port's eval head of a cell on ``device``: ``scores(frames)``
    gives its logits (deepq: its Q values) as numpy, threading the carry
    of a recurrent head; ``observe(done)`` hands it the step's dones."""

    def __init__(self, cell: Cell, device):
        self.q = cell.alg in Q_ALGS
        self.recurrent = cell.network in RECURRENT_NETWORKS
        self.module = load_eval_params(cell.alg, cell.network, cell.path,
                                       cell.game, device=device)
        self.carry = (self.module.initial_carry(cell.n) if self.recurrent
                      else None)
        self.done = torch.zeros(cell.n, dtype=torch.bool, device=device)

    @torch.no_grad()
    def scores(self, frames) -> np.ndarray:
        if self.recurrent:
            out, _, self.carry = self.module(frames, self.carry, self.done)
        else:
            out = self.module(frames)
            out = out if self.q else out[0]
        return out.cpu().numpy()

    def observe(self, done) -> None:
        self.done = done


def port_actions(q: bool, ts: np.ndarray, draw) -> np.ndarray:
    """The port's actions from its scores ``ts`` and JAX's draw: deepq's
    (explore mask, random action), else the Gumbel noise."""
    if q:
        explore, rand = draw
        return np.where(explore, rand, ts.argmax(-1))
    return gumbel_max(torch.from_numpy(ts),
                      torch.from_numpy(np.array(draw))).numpy()


def compare(q: bool, ja, js, ts, draw):
    """(the flip of the first env whose actions differ, or None; the
    largest score difference): its margin is between JAX's top two
    ``logits + g`` (deepq: Q values)."""
    diff = float(np.abs(js - ts).max())
    ta = port_actions(q, ts, draw)
    if np.array_equal(ja, ta):
        return None, diff
    e = int(np.argmax(ja != ta))
    top = np.sort(js[e] if q else js[e] + draw[e])
    return Flip(-1, e, float(top[-1] - top[-2]), diff), diff


class JaxPlay:
    """The JAX package's play of a cell on the CPU, step by step:
    ``act()`` -> (actions, scores, draw) from JAX's head with the key
    schedule of ``PRNGKey(seed)``, ``step(actions)`` -> (raw rewards,
    dones). With ``record`` it keeps every step for ``save``."""

    def __init__(self, cell: Cell, record: bool = False):
        import jax
        import jax.numpy as jnp

        self.jax, self.jnp = jax, jnp
        self.q = cell.alg in Q_ALGS
        self.n_act = len(LEGAL_ACTIONS[cell.game])
        from toybox_tpu.rl.eval_adapter import load_eval_params as j_load
        self.params = j_load(cell.alg, cell.network, cell.path, cell.game)
        self.head = _jax_head(cell.alg, cell.network, self.n_act)
        seeds = jnp.arange(cell.n, dtype=jnp.uint32) + jnp.uint32(cell.seed)
        if cell.scenario in (None, "control"):
            j_reset, self.j_step = _jax_env(cell.game, cell.n)
            self.st, _ = j_reset(seeds)
        else:
            from toybox_tpu.games import get_game as j_get_game
            from toybox_tpu.sample_tests.runner import \
                capture_setup as j_capture_setup
            jm = j_get_game(cell.game)
            cfg_js, st_js = j_capture_setup(_jax_scenario(
                cell.game, cell.scenario, cell.seed))
            jcfg = jm.config_from_json(cfg_js)
            j_reset_to, self.j_step = _jax_scenario_env(cell.game, cell.n,
                                                        jcfg)
            self.st, _ = j_reset_to(jm.state_from_json(jcfg, st_js), seeds)
        self.key = jax.random.PRNGKey(cell.seed)
        self.carry = None
        if cell.network in RECURRENT_NETWORKS:
            from toybox_tpu.rl.models import LSTMTrunk
            self.carry = LSTMTrunk.initial_carry(cell.n, NLSTM)
        self.done = jnp.zeros(cell.n, bool)
        self.log = [] if record else None

    def act(self):
        jax, jnp = self.jax, self.jnp
        self.key, akey = jax.random.split(self.key)
        ja, js, self.carry = self.head(self.params, self.st.frames, akey,
                                       self.carry, self.done)
        ja, js = np.asarray(ja), np.asarray(js)
        n = len(ja)
        if self.q:
            ekey, rkey = jax.random.split(akey)
            draw = (np.asarray(jax.random.uniform(ekey, (n,)) < EPS),
                    np.asarray(jax.random.randint(rkey, (n,), 0,
                                                  self.n_act)))
            mine = np.where(draw[0], draw[1], js.argmax(-1))
        else:
            draw = np.asarray(jax.random.gumbel(akey, (n, self.n_act),
                                                jnp.float32))
            mine = (js + draw).argmax(-1)
        assert np.array_equal(ja, mine), \
            "the draws are not the ones JAX's head made"
        self.last = (ja, js, draw)
        return ja, js, draw

    def step(self, ja):
        self.st, _, _, done, info = self.j_step(self.st,
                                                self.jnp.asarray(ja))
        self.done = done
        r, d = np.asarray(info["raw_reward"]), np.asarray(done)
        if self.log is not None:
            self.log.append(self.last + (r, d))
        return r, d

    def save(self, path: str, cell: Cell) -> None:
        ja, js, draw, r, d = zip(*self.log)
        extra = (dict(explore=np.stack([x[0] for x in draw]),
                      rand=np.stack([x[1] for x in draw])) if self.q
                 else dict(gumbel=np.stack(draw)))
        np.savez_compressed(path, cell=json.dumps(dataclasses.asdict(cell)),
                            actions=np.stack(ja), scores=np.stack(js),
                            raw_reward=np.stack(r), done=np.stack(d),
                            **extra)


class Recorded:
    """A JaxPlay saved by ``--record``, played back through the same
    ``act``/``step`` interface; ``steps`` is how many it holds."""

    def __init__(self, path: str):
        z = np.load(path)
        self.cell = Cell(**json.loads(str(z["cell"])))
        self.z = {k: z[k] for k in z.files if k != "cell"}
        self.steps = len(self.z["actions"])
        self.i = 0

    def act(self):
        z, i = self.z, self.i
        draw = ((z["explore"][i], z["rand"][i]) if "explore" in z
                else z["gumbel"][i])
        return z["actions"][i], z["scores"][i], draw

    def step(self, ja):
        r, d = self.z["raw_reward"][self.i], self.z["done"][self.i]
        self.i += 1
        return r, d


def play(cell: Cell, jax_side, device="cpu") -> Play:
    """Step the port on ``device`` beside ``jax_side`` (a JaxPlay or a
    Recorded play), both taking JAX's actions; stop at the end of a chunk
    of CHUNK agent steps once every game has finished (its first game
    over, or a raw score above the cell's cap), or after ``cell.steps``
    (or the recorded play's end)."""
    tenv, tst = port_start(cell, device)
    head = PortHead(cell, device)
    q = cell.alg in Q_ALGS
    totals, finished = np.zeros(cell.n), np.zeros(cell.n, bool)
    flips, worst = [], 0.0
    for i in range(min(cell.steps, getattr(jax_side, "steps", cell.steps))):
        ja, js, draw = jax_side.act()
        flip, diff = compare(q, ja, js, head.scores(tst.frames), draw)
        worst = max(worst, diff)
        if flip is not None:
            flip.step = i
            flips.append(flip)
        tst, _, _, td, ti = tenv.step(
            tst, torch.from_numpy(np.array(ja)).to(device))
        r, jd = jax_side.step(ja)
        if not (np.array_equal(ti["raw_reward"].cpu().numpy(), r)
                and np.array_equal(td.cpu().numpy(), jd)):
            return Play(i + 1, totals, flips, worst,
                        f"rewards or dones differ at agent step {i}")
        head.observe(td)
        totals = np.where(finished, totals, totals + r)
        finished |= jd | ((totals > cell.cap) if cell.cap is not None
                          else False)
        if finished.all() and i % CHUNK == CHUNK - 1:
            break
    return Play(i + 1, totals, flips, worst)


def lockstep(cell: Cell, record: str | None = None) -> Play:
    """Play a cell through both packages on the CPU; with ``record``, save
    JAX's side to that file."""
    jax_side = JaxPlay(cell, record=record is not None)
    result = play(cell, jax_side)
    if record is not None:
        jax_side.save(record, cell)
    return result


# ---------------------------------------------------------------------------
# The JAX package's side (imported only by the modes that play it)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_head(alg: str, network: str, n_act: int):
    """JAX's eval head, jitted: (params, obs, akey, carry, prev_done) ->
    (actions, logits or Q, carry), drawn as ``toybox_tpu.rl.policies``
    draws (recurrent: ``CategoricalPd(logits).sample``)."""
    import jax

    from toybox_tpu.rl.distributions import CategoricalPd
    from toybox_tpu.rl.models import get_network_builder
    from toybox_tpu.rl.policies import build_eval_policy

    if network in RECURRENT_NETWORKS:
        from toybox_tpu.rl.acer import RecurrentQPolicy
        from toybox_tpu.rl.ppo_recurrent import RecurrentPolicyWithValue
        cls = RecurrentQPolicy if alg == "acer" else RecurrentPolicyWithValue
        module = cls(trunk=get_network_builder(network)(nlstm=NLSTM),
                     n_actions=n_act)

        def step(params, obs, key, carry, prev_done):
            logits, _, carry = module.apply(params, obs, carry, prev_done)
            return CategoricalPd(logits).sample(key), logits, carry
    else:
        _, p_step = build_eval_policy(alg, (84, 84, 4), n_act, network)

        def step(params, obs, key, carry, prev_done):
            actions, _, _, scores = p_step(params, obs, key)
            return actions, scores, carry
    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def _jax_env(game: str, n: int) -> tuple:
    """JAX's regress env of ``n`` games: its jitted reset and step, kept
    for the process (the compiles take seconds)."""
    import jax

    from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
    env = j_make_rl_env(game, n, episodic_life=False, clip_rewards=False)
    return jax.jit(env.reset), jax.jit(env.step)


def _jax_scenario_env(game: str, n: int, cfg) -> tuple:
    """JAX's env of ``n`` games under a scenario's config: its jitted
    ``reset_to`` (reseeding) and step."""
    import jax

    from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
    env = j_make_rl_env(game, n, config=cfg, episodic_life=False,
                        clip_rewards=False)
    return (jax.jit(functools.partial(env.reset_to, reseed=True)),
            jax.jit(env.step))


def _jax_scenario(game: str, name: str, seed: int):
    """The JAX package's instance of scenario ``name`` (never
    ``control``, which starts from reset)."""
    import toybox_tpu.sample_tests as j_st
    return {c.__name__: c for c in j_st.get_scenarios(game)}[name](
        seed=seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("target", nargs="*",
                    help="<game> <family or checkpoint> <scenario|control>")
    ap.add_argument("--regress", metavar="CHECKPOINT", default=None)
    ap.add_argument("--episodes", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", metavar="NPZ", default=None,
                    help="save JAX's side of the play")
    ap.add_argument("--replay", metavar="NPZ", default=None,
                    help="play the port alone against a recorded play")
    ap.add_argument("--device", default="cpu",
                    help="the port's device in --replay")
    args = ap.parse_args(argv)
    full_f32()
    if args.replay:
        jax_side = Recorded(args.replay)
        cell = jax_side.cell
        what = f"replay {args.replay} on {args.device}"
        result = play(cell, jax_side, args.device)
    else:
        if args.regress:
            cell = regress_cell(args.regress, args.seed)
            what = f"regress {args.regress}"
        elif len(args.target) == 3:
            cell = scenario_cell(*args.target, seed=args.seed,
                                 episodes=args.episodes)
            what = " ".join(args.target)
        else:
            ap.error("give <game> <family or checkpoint> <scenario>, "
                     "--regress <checkpoint> or --replay <npz>")
        result = lockstep(cell, args.record)
    print(f"{what} seed {cell.seed}: {result.steps} agent steps, scores "
          f"{result.totals.tolist()}, mean {result.totals.mean():.6g}")
    if result.fault:
        print(f"FAULT: {result.fault}")
        return 1
    print(f"largest logit (or Q) difference {result.worst:.3g}; actions "
          f"differed at {len(result.flips)} steps (step, env, margin, "
          "difference):")
    for f in result.flips:
        tie = "near tie" if near_tie(f.margin, f.diff) else "NOT A NEAR TIE"
        print(f"  {f.step} env {f.env}: {f.margin:.3g}, {f.diff:.3g} "
              f"({tie})")
    return 0 if result.chance else 1


if __name__ == "__main__":
    raise SystemExit(main())

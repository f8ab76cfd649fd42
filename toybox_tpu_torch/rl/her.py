"""HER, hindsight experience replay (port of toybox_tpu.rl.her: the
bit-flip and point-goal envs, ``make_her``, ``make_her_ddpg`` and
``learn``).

The semantics are the JAX package's (the reference baselines/her):
goal-conditioned off-policy learning in which stored episodes are
relabeled with achieved goals. With the "future" strategy and replay_k 4,
each sampled transition's goal is replaced, with probability
replay_k / (replay_k + 1), by the state achieved at a random later step
of the same episode.

- ``make_her_ddpg``: goal-conditioned DDPG (the reference her/ddpg.py):
  running o and g normalizers (``ppo1.ObFilter``), epsilon-random plus
  Gaussian exploration, the target clipped to [-1/(1-gamma), 0], an
  action_l2 penalty on the actor and Polyak-averaged targets, on a
  point-mass reacher.
- ``make_her``: a goal-conditioned DQN on the bit-flipping testbed, the
  target network replaced every ``target_update`` cycles.

A cycle resets every env, rolls out one whole episode batch (no early
stop: a solved bit-flip episode freezes, a point-goal episode runs its
horizon), stores it in an episode ring and takes SGD steps on relabeled
samples. The ring's cursor and size and the cycle count are host
integers. A cycle's draws come from the state's generator unless a
caller hands them in (``draws=``), as the tests do with JAX's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
from torch import nn

from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.models import init_trunk
from toybox_tpu_torch.rl.ppo1 import ObFilter

F32 = torch.float32
I32 = torch.int32


def future_offsets(tt: torch.Tensor, u: torch.Tensor, T: int):
    """The "future" strategy's offsets, uniform in [0, max(T - tt, 1))
    for each sampled step tt. JAX's randint takes a bound per element,
    torch's one bound for all, so the offset is floor(u * bound) of
    uniforms u, kept below the bound (f32 rounding of u * bound can reach
    it)."""
    bound = torch.clamp_min(T - tt, 1)
    return torch.minimum(torch.floor(u * bound).long(), bound - 1)


def _adam_step(module: nn.Module, loss: torch.Tensor, adam: ppo.AdamState,
               lr: float) -> None:
    """One optax.adam step (eps 1e-8) of ``module`` on ``loss``."""
    params = list(module.parameters())
    ppo.adam_update(params, torch.autograd.grad(loss, params), adam, lr,
                    eps=1e-8)


def _frozen_copy(module: nn.Module) -> nn.Module:
    return copy.deepcopy(module).requires_grad_(False)


# ---------------------------------------------------------------------------
# The bit-flip goal env (the canonical HER testbed)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BitFlipState:
    bits: torch.Tensor           # bool[N, n]
    goal: torch.Tensor           # bool[N, n]
    t: torch.Tensor              # i32[N]
    generator: torch.Generator   # auto-reset draws (advanced in place)


def make_bitflip_env(num_envs: int, n_bits: int = 8, device="cuda"):
    """(reset, step, n_bits). Action i flips bit i; the reward is 0 when
    the bits equal the goal, else -1; an episode lasts n_bits steps or
    until solved, and a solved env stays frozen until it is reset.

    - reset(seeds, start=None) -> (state, obs): bits and goal drawn from a
      generator seeded with the seeds' sum, or ``start`` = (bits, goal);
    - step(state, actions, auto_reset=True, fresh=None) -> (state, obs,
      reward, done, info): with auto_reset, a done env starts over from
      new bits and goal, drawn on every step (``fresh`` = (bits, goal)
      replaces the draw); info holds ``achieved`` (the bits after the
      action) and ``solved``.
    obs is f32[N, 2 n]: the bits, then the goal."""
    dev = torch.device(device)

    def _new(gen):
        bits = torch.rand((num_envs, n_bits), generator=gen, device=dev) < .5
        goal = torch.rand((num_envs, n_bits), generator=gen, device=dev) < .5
        return bits, goal

    def obs_of(bits, goal):
        return torch.cat([bits.to(F32), goal.to(F32)], -1)

    def reset(seeds, start=None):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(torch.as_tensor(seeds).sum()))
        bits, goal = (_new(gen) if start is None else
                      (torch.as_tensor(s, device=dev).bool() for s in start))
        st = BitFlipState(bits=bits, goal=goal,
                          t=torch.zeros(num_envs, dtype=I32, device=dev),
                          generator=gen)
        return st, obs_of(bits, goal)

    def step(state: BitFlipState, actions, auto_reset=True, fresh=None):
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(actions, device=dev).long(), n_bits).bool()
        # once solved, freeze (self-loop) so stored episodes stay coherent
        already = (state.bits == state.goal).all(-1)
        bits = torch.where(already[:, None], state.bits, state.bits ^ onehot)
        solved = (bits == state.goal).all(-1)
        reward = torch.where(solved, 0.0, -1.0)
        t = state.t + 1
        done = solved | (t >= n_bits)
        new_bits, new_goal = bits, state.goal
        if auto_reset:
            nb, ng = (_new(state.generator) if fresh is None else
                      (torch.as_tensor(s, device=dev).bool() for s in fresh))
            new_bits = torch.where(done[:, None], nb, bits)
            new_goal = torch.where(done[:, None], ng, state.goal)
            t = torch.where(done, torch.zeros_like(t), t)
        st = BitFlipState(bits=new_bits, goal=new_goal, t=t,
                          generator=state.generator)
        info = {"achieved": bits, "solved": solved}
        return st, obs_of(new_bits, new_goal), reward, done, info

    return reset, step, n_bits


# ---------------------------------------------------------------------------
# Goal-conditioned DQN with hindsight relabeling
# ---------------------------------------------------------------------------

class GoalQNet(nn.Module):
    """obs [N, 2 n] -> Q [N, n_actions]: two relu Dense layers of
    ``hidden``, then a Dense."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 256):
        super().__init__()
        sizes = (obs_dim, hidden, hidden, n_actions)
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in
                                     zip(sizes[:-1], sizes[1:])])

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.to(F32)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


@dataclasses.dataclass
class HERReplay:
    """The episode ring, env axis kept: bits [cap, T+1, N, n] (the states
    of each step and the last), goals [cap, N, n], actions [cap, T, N]
    (int64). cursor and size are host integers."""
    bits: torch.Tensor
    goals: torch.Tensor
    actions: torch.Tensor
    cursor: int = 0
    size: int = 0


@dataclasses.dataclass
class HERState:
    """The whole training state; a cycle updates it in place."""
    qnet: nn.Module
    target_qnet: nn.Module
    adam: ppo.AdamState
    env_state: Any
    replay: HERReplay
    generator: torch.Generator   # resets, exploration, samples
    t: int = 0                   # cycles taken


def make_her(num_envs=16, n_bits=8, *, lr=1e-3, gamma=0.98, buffer_eps=256,
             batch_size=128, eps_greedy=0.2, replay_k=4, target_update=40,
             device="cuda"):
    """Build (init_fn, cycle, qnet) on ``device``:

    - init_fn(seed) -> HERState: the Q network initialised as flax
      initialises Dense layers (from a CPU generator seeded with
      ``seed``), the target a copy, zero Adam moments, an empty ring;
    - cycle(state, draws=None) -> (state, metrics): every env reset, one
      episode of T = n_bits eps-greedy steps (no auto-reset), stored; one
      Adam step on batch_size relabeled samples; the target replaced when
      the cycle count reaches a multiple of target_update. ``draws``:
      ``bits`` and ``goal`` bool[N, n] (the reset), ``explore_u`` f32[T,
      N] and ``rand_actions`` [T, N] (exploration), ``ep``, ``tt``,
      ``en`` [B] int (the samples: episode below max(size, 1) after the
      insert, step, env), ``fut_off`` [B] int (the future offsets, each
      below max(T - tt, 1): ``future_offsets``) and ``her_u`` f32[B] (the
      relabel coins); the future state is step min(tt + 1 + fut_off, T).
      metrics: ``loss`` and ``success_rate``, the share of envs whose
      episode reached its goal at any of its T + 1 states;
    - qnet: the Q network module."""
    dev = torch.device(device)
    T = n_bits
    reset_env, step_env, _ = make_bitflip_env(num_envs, n_bits, dev)
    qnet = GoalQNet(2 * n_bits, n_bits).to(dev)

    def obs_of(bits, goal):
        return torch.cat([bits.to(F32), goal.to(F32)], -1)

    def init_fn(seed: int = 0) -> HERState:
        cpu = GoalQNet(2 * n_bits, n_bits)
        init_trunk(cpu, torch.Generator().manual_seed(seed))
        qnet.load_state_dict(cpu.state_dict())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        env_state, _ = reset_env(torch.arange(num_envs) + seed)
        replay = HERReplay(
            bits=torch.zeros((buffer_eps, T + 1, num_envs, n_bits),
                             dtype=torch.bool, device=dev),
            goals=torch.zeros((buffer_eps, num_envs, n_bits),
                              dtype=torch.bool, device=dev),
            actions=torch.zeros((buffer_eps, T, num_envs), dtype=torch.long,
                                device=dev))
        return HERState(
            qnet=qnet, target_qnet=_frozen_copy(qnet),
            adam=ppo.AdamState.zeros_like(list(qnet.parameters())),
            env_state=env_state, replay=replay, generator=gen)

    def draw(gen, size):
        """A cycle's draws before the ring's size is known to the rollout;
        ``ep`` is drawn after the insert (``size``)."""
        def u(*shape):
            return torch.rand(shape, generator=gen, device=dev)
        bits, goal = u(num_envs, n_bits) < .5, u(num_envs, n_bits) < .5
        d = {"bits": bits, "goal": goal, "explore_u": u(T, num_envs),
             "rand_actions": torch.randint(0, n_bits, (T, num_envs),
                                           generator=gen, device=dev)}
        d["ep"] = torch.randint(0, max(size, 1), (batch_size,),
                                generator=gen, device=dev)
        d["tt"] = torch.randint(0, T, (batch_size,), generator=gen,
                                device=dev)
        d["en"] = torch.randint(0, num_envs, (batch_size,), generator=gen,
                                device=dev)
        d["fut_off"] = future_offsets(d["tt"], u(batch_size), T)
        d["her_u"] = u(batch_size)
        return d

    def cycle(state: HERState, draws: dict | None = None):
        rb, cap = state.replay, state.replay.bits.shape[0]
        size = min(rb.size + 1, cap)
        if draws is None:
            draws = draw(state.generator, size)
        # force-synchronized episodes: reset all envs
        env_state, _ = reset_env(0, start=(draws["bits"], draws["goal"]))
        goal0 = env_state.goal
        bits_seq, act_seq = [], []
        with torch.no_grad():
            for t in range(T):
                q = state.qnet(obs_of(env_state.bits, env_state.goal))
                explore = draws["explore_u"][t] < eps_greedy
                actions = torch.where(explore, draws["rand_actions"][t].long(),
                                      q.argmax(-1))
                bits_seq.append(env_state.bits)
                act_seq.append(actions)
                env_state = step_env(env_state, actions, auto_reset=False)[0]
        # the states before each action, then the last: [T+1, N, n]
        bits_all = torch.stack(bits_seq + [env_state.bits])
        state.env_state = env_state

        cur = rb.cursor
        rb.bits[cur] = bits_all
        rb.goals[cur] = goal0
        rb.actions[cur] = torch.stack(act_seq)
        rb.cursor, rb.size = (cur + 1) % cap, size

        # sample, relabel with hindsight, one Adam step
        ep, tt, en = draws["ep"], draws["tt"], draws["en"]
        s, s_next = rb.bits[ep, tt, en], rb.bits[ep, tt + 1, en]
        a = rb.actions[ep, tt, en]
        fut = torch.clamp(tt + 1 + draws["fut_off"], 0, T)
        g_fut = rb.bits[ep, fut, en]
        use_her = draws["her_u"] < replay_k / (replay_k + 1)
        goal = torch.where(use_her[:, None], g_fut, rb.goals[ep, en])
        solved_next = (s_next == goal).all(-1)
        r = torch.where(solved_next, 0.0, -1.0)
        with torch.no_grad():
            qn = state.target_qnet(obs_of(s_next, goal))
            target = r + gamma * (1 - solved_next.to(F32)) * qn.max(-1).values
            # clip the target to the feasible return range [-T, 0]
            target = torch.clamp(target, -float(T), 0.0)
        q_a = state.qnet(obs_of(s, goal)).gather(-1, a[:, None])[:, 0]
        loss = torch.square(q_a - target).mean()
        _adam_step(state.qnet, loss, state.adam, lr)

        state.t += 1
        if state.t % target_update == 0:
            state.target_qnet.load_state_dict(state.qnet.state_dict())
        # success: did the episode reach its original goal at any state?
        success = (bits_all == goal0[None]).all(-1).any(0).to(F32).mean()
        return state, dict(loss=loss.detach(), success_rate=success)

    return init_fn, cycle, qnet


# ---------------------------------------------------------------------------
# The continuous vector goal env: a point-mass reacher
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PointGoalState:
    pos: torch.Tensor            # f32[N, d]
    goal: torch.Tensor           # f32[N, d]
    t: torch.Tensor              # i32[N]
    generator: torch.Generator


def make_point_goal_env(num_envs: int, dim: int = 2, episode_len: int = 20,
                        eps: float = 0.1, max_step: float = 0.2,
                        device="cuda"):
    """(reset, step, is_success, episode_len): a sparse-reward reacher in
    [-1, 1]^dim. The action is a velocity clipped to [-1, 1] and scaled by
    max_step, the position clipped to the box; the reward is 0 within eps
    of the goal, else -1 (the Fetch envs' reward). Episodes have a fixed
    length: no early termination, only the horizon.

    - reset(seeds, start=None) -> state: position and goal uniform in
      [-1, 1) from a generator seeded with the seeds' sum, or ``start`` =
      (pos, goal);
    - step(state, actions) -> (state, reward, done);
    - is_success(pos, goal) -> bool[N]."""
    dev = torch.device(device)

    def reset(seeds, start=None):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(torch.as_tensor(seeds).sum()))
        if start is None:
            pos, goal = (torch.rand((num_envs, dim), generator=gen,
                                    device=dev) * 2.0 - 1.0
                         for _ in range(2))
        else:
            pos, goal = (torch.as_tensor(s, dtype=F32, device=dev)
                         for s in start)
        return PointGoalState(pos=pos, goal=goal,
                              t=torch.zeros(num_envs, dtype=I32, device=dev),
                              generator=gen)

    def is_success(pos, goal):
        return torch.linalg.vector_norm(pos - goal, dim=-1) < eps

    def step(state: PointGoalState, actions):
        vel = torch.clamp(actions, -1.0, 1.0) * max_step
        pos = torch.clamp(state.pos + vel, -1.0, 1.0)
        reward = torch.where(is_success(pos, state.goal), 0.0, -1.0)
        t = state.t + 1
        st = dataclasses.replace(state, pos=pos, t=t)
        return st, reward, t >= episode_len

    return reset, step, is_success, episode_len


# ---------------------------------------------------------------------------
# Goal-conditioned DDPG (the reference her/ddpg.py stack)
# ---------------------------------------------------------------------------

class GoalActor(nn.Module):
    """og [N, 2 d] -> action [N, d]: three relu Dense layers of
    ``hidden``, then tanh of a Dense."""

    def __init__(self, og_dim: int, action_dim: int, hidden: int = 256):
        super().__init__()
        sizes = (og_dim, hidden, hidden, hidden, action_dim)
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in
                                     zip(sizes[:-1], sizes[1:])])

    def forward(self, og: torch.Tensor) -> torch.Tensor:
        x = og
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return torch.tanh(self.layers[-1](x))


class GoalCritic(nn.Module):
    """(og, action) -> Q [N]: concat(og, action), three relu Dense layers
    of ``hidden``, then a Dense to one output."""

    def __init__(self, og_dim: int, action_dim: int, hidden: int = 256):
        super().__init__()
        sizes = (og_dim + action_dim, hidden, hidden, hidden, 1)
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in
                                     zip(sizes[:-1], sizes[1:])])

    def forward(self, og: torch.Tensor, action: torch.Tensor):
        x = torch.cat([og, action], -1)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[..., 0]


@dataclasses.dataclass
class HERDDPGReplay:
    """The episode ring (the reference her/replay_buffer.py layout, env
    axis kept): o and ag [cap, T+1, N, d], g [cap, N, d], u [cap, T, N,
    d]. cursor and size are host integers."""
    o: torch.Tensor
    ag: torch.Tensor
    g: torch.Tensor
    u: torch.Tensor
    cursor: int = 0
    size: int = 0


@dataclasses.dataclass
class HERDDPGState:
    """The whole training state; a cycle updates it in place."""
    actor: nn.Module
    critic: nn.Module
    target_actor: nn.Module
    target_critic: nn.Module
    actor_adam: ppo.AdamState
    critic_adam: ppo.AdamState
    o_stats: ObFilter            # running normalizer of observations
    g_stats: ObFilter            # and of goals
    replay: HERDDPGReplay
    generator: torch.Generator   # resets, exploration, samples
    t: int = 0                   # cycles taken


def make_her_ddpg(num_envs=16, dim=2, *, episode_len=20,
                  replay_strategy="future", replay_k=4, buffer_eps=128,
                  batch_size=256, n_batches=4, q_lr=1e-3, pi_lr=1e-3,
                  polyak=0.95, action_l2=1.0, noise_eps=0.2, random_eps=0.3,
                  gamma=None, goal_eps=0.1, device="cuda"):
    """Build (init_fn, cycle) for goal-conditioned DDPG with HER on the
    point-goal env, on ``device``. replay_strategy "future" relabels with
    achieved later goals, "none" does not (plain DDPG, the reference's
    ablation switch). The defaults are the reference's
    her/experiment/config.py: replay_k 4, polyak 0.95, action_l2 1,
    noise_eps 0.2, random_eps 0.3, gamma 1 - 1/T.

    - init_fn(seed) -> HERDDPGState: the actor (``seed``) and critic
      (``seed + 1``) initialised as flax initialises Dense layers, the
      targets copies, zero Adam moments, fresh normalizers, an empty ring;
    - cycle(state, draws=None) -> (state, metrics): every env reset, one
      episode of T steps with exploration (the rollout normalizes with the
      normalizers as they were), stored; the normalizers updated with the
      episode's observations and goals; n_batches SGD steps on the ring
      after the insert, each the critic's Adam step, then the actor's
      through the updated critic, then both Polyak averages. ``draws``:
      ``pos`` and ``goal`` f32[N, d] (the reset), ``noise`` f32[T, N, d]
      standard normal, ``rand_coin`` f32[T, N, 1] (one epsilon-random coin
      per env), ``rand_u`` f32[T, N, d] uniform in [-1, 1), and for the
      SGD steps ``ep``, ``tt``, ``en``, ``fut_off`` int[n_batches, B] and
      ``her_u`` f32[n_batches, B] (as ``make_her``'s). metrics:
      ``critic_loss`` and ``actor_loss`` (means over the steps) and
      ``success_rate``, the share of envs whose final position lies within
      goal_eps of the goal."""
    dev = torch.device(device)
    reset_env, step_env, is_success, T = make_point_goal_env(
        num_envs, dim, episode_len, eps=goal_eps, device=dev)
    if gamma is None:
        gamma = 1.0 - 1.0 / T
    clip_return = 1.0 / (1.0 - gamma)
    future_p = (replay_k / (replay_k + 1.0)
                if replay_strategy == "future" else 0.0)
    actor = GoalActor(2 * dim, dim).to(dev)
    critic = GoalCritic(2 * dim, dim).to(dev)

    def norm_og(o_stats, g_stats, o, g):
        return torch.cat([o_stats.normalize(o), g_stats.normalize(g)], -1)

    def init_fn(seed: int = 0) -> HERDDPGState:
        for module, cls, s in ((actor, GoalActor, seed),
                               (critic, GoalCritic, seed + 1)):
            cpu = cls(2 * dim, dim)
            init_trunk(cpu, torch.Generator().manual_seed(s))
            module.load_state_dict(cpu.state_dict())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def zeros(*shape):
            return torch.zeros((buffer_eps,) + shape, dtype=F32, device=dev)

        replay = HERDDPGReplay(o=zeros(T + 1, num_envs, dim),
                               ag=zeros(T + 1, num_envs, dim),
                               g=zeros(num_envs, dim),
                               u=zeros(T, num_envs, dim))
        return HERDDPGState(
            actor=actor, critic=critic, target_actor=_frozen_copy(actor),
            target_critic=_frozen_copy(critic),
            actor_adam=ppo.AdamState.zeros_like(list(actor.parameters())),
            critic_adam=ppo.AdamState.zeros_like(list(critic.parameters())),
            o_stats=ObFilter.create((dim,), dev),
            g_stats=ObFilter.create((dim,), dev), replay=replay,
            generator=gen)

    def draw(gen, size):
        def u(*shape):
            return torch.rand(shape, generator=gen, device=dev)
        d = {"pos": u(num_envs, dim) * 2 - 1, "goal": u(num_envs, dim) * 2 - 1,
             "noise": torch.randn((T, num_envs, dim), generator=gen,
                                  device=dev),
             "rand_coin": u(T, num_envs, 1), "rand_u": u(T, num_envs, dim) * 2 - 1}
        shape = (n_batches, batch_size)
        d["ep"] = torch.randint(0, max(size, 1), shape, generator=gen,
                                device=dev)
        d["tt"] = torch.randint(0, T, shape, generator=gen, device=dev)
        d["en"] = torch.randint(0, num_envs, shape, generator=gen, device=dev)
        d["fut_off"] = future_offsets(d["tt"], u(*shape), T)
        d["her_u"] = u(*shape)
        return d

    def cycle(state: HERDDPGState, draws: dict | None = None):
        rb, cap = state.replay, state.replay.o.shape[0]
        size = min(rb.size + 1, cap)
        if draws is None:
            draws = draw(state.generator, size)
        env_state = reset_env(0, start=(draws["pos"], draws["goal"]))
        g = env_state.goal
        o_seq, u_seq = [], []
        with torch.no_grad():
            for t in range(T):
                og = norm_og(state.o_stats, state.g_stats, env_state.pos,
                             env_state.goal)
                pi = state.actor(og)
                # gaussian noise + epsilon-random actions (rollout.py)
                noisy = pi + noise_eps * draws["noise"][t]
                take_rand = draws["rand_coin"][t] < random_eps
                u = torch.clamp(torch.where(take_rand, draws["rand_u"][t],
                                            noisy), -1.0, 1.0)
                o_seq.append(env_state.pos)
                u_seq.append(u)
                env_state = step_env(env_state, u)[0]
        o_all = torch.stack(o_seq + [env_state.pos])
        cur = rb.cursor
        rb.o[cur] = o_all
        rb.ag[cur] = o_all      # the achieved goal is the position
        rb.g[cur] = g
        rb.u[cur] = torch.stack(u_seq)
        rb.cursor, rb.size = (cur + 1) % cap, size

        # the normalizers learn from the fresh episode (store_episode)
        state.o_stats = state.o_stats.update(o_all.reshape(-1, dim))
        state.g_stats = state.g_stats.update(g.reshape(-1, dim))

        closses, alosses = [], []
        for b in range(n_batches):
            ep, tt, en = draws["ep"][b], draws["tt"][b], draws["en"][b]
            o, o2 = rb.o[ep, tt, en], rb.o[ep, tt + 1, en]
            fut = torch.clamp(tt + 1 + draws["fut_off"][b], 0, T)
            g_fut = rb.ag[ep, fut, en]
            use_her = draws["her_u"][b] < future_p
            goal = torch.where(use_her[:, None], g_fut, rb.g[ep, en])
            # the reward recomputed under the substituted goal
            r = torch.where(is_success(o2, goal), 0.0, -1.0)
            og = norm_og(state.o_stats, state.g_stats, o, goal)
            og2 = norm_og(state.o_stats, state.g_stats, o2, goal)
            with torch.no_grad():
                q2 = state.target_critic(og2, state.target_actor(og2))
                # feasible-return clipping
                target = torch.clamp(r + gamma * q2, -clip_return, 0.0)
            closs = torch.square(state.critic(og, rb.u[ep, tt, en])
                                 - target).mean()
            _adam_step(state.critic, closs, state.critic_adam, q_lr)
            # the actor's loss reads the critic just updated
            pi = state.actor(og)
            aloss = (-state.critic(og, pi).mean()
                     + action_l2 * torch.square(pi).mean())
            _adam_step(state.actor, aloss, state.actor_adam, pi_lr)
            with torch.no_grad():
                for tgt, online in ((state.target_actor, state.actor),
                                    (state.target_critic, state.critic)):
                    for p_t, p in zip(tgt.parameters(), online.parameters()):
                        p_t.copy_(polyak * p_t + (1 - polyak) * p)
            closses.append(closs.detach())
            alosses.append(aloss.detach())

        state.t += 1
        # success: the episode's final position (rollout.py)
        success = is_success(env_state.pos, g).to(F32).mean()
        return state, dict(critic_loss=torch.stack(closses).mean(),
                           actor_loss=torch.stack(alosses).mean(),
                           success_rate=success)

    return init_fn, cycle


def learn(*, n_bits=8, num_envs=16, total_episodes=2000, seed=0, lr=1e-3,
          gamma=0.98, replay_k=4, log_interval=100, logger=None,
          backend="ddpg", dim=2, episode_len=20, device="cuda", **_ignored):
    """backend "ddpg" trains goal-conditioned DDPG on the point-goal env,
    "dqn" the bit-flip goal DQN, total_episodes // num_envs cycles; every
    ``log_interval`` cycles the metrics are read to the host at once.
    Returns the state (nothing is saved, as in JAX). TF32 is off; other
    keyword arguments are ignored, as in JAX."""
    full_f32()
    if backend == "ddpg":
        init_fn, cycle = make_her_ddpg(num_envs, dim,
                                       episode_len=episode_len,
                                       replay_k=replay_k, device=device)
    else:
        init_fn, cycle, _ = make_her(num_envs, n_bits, lr=lr, gamma=gamma,
                                     replay_k=replay_k, device=device)
    state = init_fn(seed)
    for i in range(1, max(total_episodes // num_envs, 1) + 1):
        state, metrics = cycle(state)
        if logger is not None and i % log_interval == 0:
            host = torch.stack([v.to(F32) for v in metrics.values()])
            for k, v in zip(metrics, host.tolist()):
                logger.logkv(k, v)
            logger.dumpkvs()
    return state

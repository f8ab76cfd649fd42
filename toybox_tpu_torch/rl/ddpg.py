"""DDPG, deep deterministic policy gradient for continuous actions (port
of toybox_tpu.rl.ddpg: ``Actor``, ``Critic``, ``make_ddpg`` and
``learn``).

The semantics are the JAX package's (the reference baselines/ddpg): an
actor and a critic with target networks Polyak-averaged at tau 0.01,
Gaussian action noise, a device replay ring, Adam (optax.adam: eps 1e-8)
at actor_lr 1e-4 and critic_lr 1e-3, gamma .99, batches of 64. Toybox's
games are discrete, so DDPG trains on Box-action envs such as
``test_envs.make_box_identity_env``.

A cycle is one env step of every env, its insert into the ring, a batch
sampled after the insert, the critic's TD step against the target nets,
the actor's step through the updated critic, and the Polyak averages.
Before ``learning_starts`` env steps the actor's Adam moments and count
advance but its parameters do not move (JAX masks the update to zero);
the critic learns from the first cycle. The env step count, the ring's
cursor and its size are host integers: they depend on the cycle count
alone. A cycle's draws (the action noise, the sample indices) come from
the state's generator unless a caller hands them in.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import torch
from torch import nn

from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.models import init_trunk

F32 = torch.float32


class Actor(nn.Module):
    """obs [N, obs_dim] -> action [N, action_dim]: relu Dense layers of
    ``hidden``, then tanh of a Dense."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        sizes = (obs_dim,) + tuple(hidden) + (action_dim,)
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in
                                     zip(sizes[:-1], sizes[1:])])

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.to(F32)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return torch.tanh(self.layers[-1](x))


class Critic(nn.Module):
    """(obs, action) -> Q [N]: concat(obs, action), relu Dense layers of
    ``hidden``, then a Dense to one output."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        sizes = (obs_dim + action_dim,) + tuple(hidden) + (1,)
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in
                                     zip(sizes[:-1], sizes[1:])])

    def forward(self, obs: torch.Tensor, action: torch.Tensor):
        x = torch.cat([obs.to(F32), action.to(F32)], -1)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[..., 0]


@dataclasses.dataclass
class DDPGReplay:
    """The replay ring (device tensors; cursor and size on the host)."""
    obs: torch.Tensor
    next_obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    cursor: int = 0
    size: int = 0


@dataclasses.dataclass
class DDPGState:
    """The whole training state; a cycle updates it in place."""
    actor: nn.Module
    critic: nn.Module
    target_actor: nn.Module
    target_critic: nn.Module
    actor_adam: ppo.AdamState
    critic_adam: ppo.AdamState
    env_state: Any
    replay: DDPGReplay
    generator: torch.Generator   # action noise and sample indices
    t: int = 0                   # env steps taken
    update: int = 0


def make_ddpg(env_fns, action_dim, *, actor_lr=1e-4, critic_lr=1e-3,
              gamma=0.99, tau=0.01, buffer_size=100_000, batch_size=64,
              noise_scale=0.1, learning_starts=256, device="cuda"):
    """Build (init_fn, cycle, actor) over a batched env with Box actions
    whose tensors lie on ``device``:

    - init_fn(seed) -> DDPGState: the actor (``seed``) and the critic
      (``seed + 1``) initialised as flax initialises Dense layers, the
      targets copies, zero Adam moments, an empty ring, the envs reset
      with seeds drawn from the state's generator;
    - cycle(state, draws=None) -> (state, metrics): draws ``noise``
      [N, action_dim] standard normal and ``idx`` [batch_size] in
      [0, max(size, 1)) of the ring after the insert;
    - actor: the actor module."""
    dev = torch.device(device)
    num_envs = env_fns.num_envs
    obs_dim = int(env_fns.obs_shape[0])
    actor = Actor(obs_dim, action_dim).to(dev)
    critic = Critic(obs_dim, action_dim).to(dev)

    def copy_of(module, cls):
        c = cls(obs_dim, action_dim).to(dev).requires_grad_(False)
        c.load_state_dict(module.state_dict())
        return c

    def init_fn(seed: int = 0) -> DDPGState:
        for module, cls, s in ((actor, Actor, seed),
                               (critic, Critic, seed + 1)):
            cpu = cls(obs_dim, action_dim)
            init_trunk(cpu, torch.Generator().manual_seed(s))
            module.load_state_dict(cpu.state_dict())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = torch.randint(0, 2**31 - 1, (num_envs,), generator=gen,
                              device=dev)
        env_state, _ = env_fns.reset(seeds)

        def zeros(*shape, dtype=F32):
            return torch.zeros((buffer_size,) + shape, dtype=dtype,
                               device=dev)

        replay = DDPGReplay(obs=zeros(obs_dim), next_obs=zeros(obs_dim),
                            actions=zeros(action_dim), rewards=zeros(),
                            dones=zeros(dtype=torch.bool))
        return DDPGState(
            actor=actor, critic=critic,
            target_actor=copy_of(actor, Actor),
            target_critic=copy_of(critic, Critic),
            actor_adam=ppo.AdamState.zeros_like(list(actor.parameters())),
            critic_adam=ppo.AdamState.zeros_like(list(critic.parameters())),
            env_state=env_state, replay=replay, generator=gen)

    def cycle(state: DDPGState, draws: dict | None = None):
        gen, rb = state.generator, state.replay
        obs = state.env_state.frames
        with torch.no_grad():
            actions = state.actor(obs)
        noise = (draws["noise"] if draws is not None else torch.randn(
            actions.shape, generator=gen, device=dev))
        actions = torch.clamp(actions + noise_scale * noise, -1.0, 1.0)
        state.env_state, next_obs, rewards, dones, _ = env_fns.step(
            state.env_state, actions)

        cap = rb.obs.shape[0]
        slots = (rb.cursor + torch.arange(num_envs, device=dev)) % cap
        rb.obs[slots] = obs.to(F32)
        rb.next_obs[slots] = next_obs.to(F32)
        rb.actions[slots] = actions
        rb.rewards[slots] = rewards
        rb.dones[slots] = dones
        rb.cursor = (rb.cursor + num_envs) % cap
        rb.size = min(rb.size + num_envs, cap)

        idx = (draws["idx"] if draws is not None else torch.randint(
            0, max(rb.size, 1), (batch_size,), generator=gen, device=dev))
        bo, bno, ba = rb.obs[idx], rb.next_obs[idx], rb.actions[idx]
        br, bd = rb.rewards[idx], rb.dones[idx]

        with torch.no_grad():
            target_q = state.target_critic(bno, state.target_actor(bno))
            y = br + gamma * (1.0 - bd.to(F32)) * target_q
        cparams = list(state.critic.parameters())
        closs = torch.square(state.critic(bo, ba) - y).mean()
        ppo.adam_update(cparams, torch.autograd.grad(closs, cparams),
                        state.critic_adam, critic_lr, eps=1e-8)

        aparams = list(state.actor.parameters())
        aloss = -state.critic(bo, state.actor(bo)).mean()
        ppo.adam_update(aparams, torch.autograd.grad(aloss, aparams),
                        state.actor_adam, actor_lr, eps=1e-8,
                        apply_step=state.t >= learning_starts)

        with torch.no_grad():
            for target, online in ((state.target_actor, state.actor),
                                   (state.target_critic, state.critic)):
                for a, b in zip(target.parameters(), online.parameters()):
                    a.copy_((1 - tau) * a + tau * b)
        state.t += num_envs
        state.update += 1
        return state, dict(critic_loss=closs.detach(),
                           actor_loss=aloss.detach(),
                           mean_reward=rewards.mean())

    return init_fn, cycle, actor


def learn(*, env, action_dim, total_timesteps=10_000, seed=0,
          actor_lr=1e-4, critic_lr=1e-3, gamma=0.99, tau=0.01,
          buffer_size=100_000, batch_size=64, noise_scale=0.1,
          learning_starts=256, log_interval=100, logger=None,
          device="cuda", **extra):
    """Train DDPG on ``env`` (Box actions, tensors on ``device``) for
    total_timesteps // num_envs cycles; returns the DDPGState (nothing is
    saved, as in JAX). TF32 is off; every ``log_interval`` cycles the
    metrics are read to the host at once."""
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    init_fn, cycle, _ = make_ddpg(
        env, action_dim, actor_lr=actor_lr, critic_lr=critic_lr,
        gamma=gamma, tau=tau, buffer_size=buffer_size,
        batch_size=batch_size, noise_scale=noise_scale,
        learning_starts=learning_starts, device=device)
    state = init_fn(seed)
    ncycles = max(int(total_timesteps) // env.num_envs, 1)
    t0 = time.perf_counter()
    for i in range(1, ncycles + 1):
        state, metrics = cycle(state)
        if logger is not None and i % log_interval == 0:
            host = torch.stack([v.to(F32) for v in metrics.values()])
            logger.logkv("steps", i * env.num_envs)
            logger.logkv("fps", int(i * env.num_envs
                                    / (time.perf_counter() - t0)))
            for k, v in zip(metrics, host.tolist()):
                logger.logkv(k, v)
            logger.dumpkvs()
    return state

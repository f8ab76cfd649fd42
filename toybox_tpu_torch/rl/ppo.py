"""PPO (port of toybox_tpu.rl.ppo: ``make_ppo``, ``learn``,
``save_params`` and ``load_params``).

The semantics are the JAX package's, which follow the reference's ppo2:
clipped surrogate, clipped value loss and entropy bonus; GAE(lambda) as a
backward loop; minibatched epochs over one permutation per epoch, with lr
and cliprange annealed by ``frac``; the atari defaults (nsteps 128, 4
minibatches, 4 epochs, lam .95, gamma .99, ent .01, lr 2.5e-4, clip .1);
and the optimizer optax.chain(clip_by_global_norm, scale_by_adam(eps=1e-5),
scale(-lr)), written out here in optax's order of operations, beside the
chains of the other on-policy learners (a2c's scale_by_rms, acktr's sgd
with momentum).

The JAX package runs a whole update as one jitted program; PyTorch runs
eagerly, so the update is split into plain functions (``rollout``,
``gae``, ``ppo_loss``, ``update``) that tests can drive on given inputs.
The training state is updated in place: the policy's parameters, the Adam
moments and the generator that draws actions and permutations. The
rollout keeps its observations in u8 storage on the device and gathers
each minibatch's rows from it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from toybox_tpu_torch.envs.pipeline import FRAME_KERNEL_GAMES, make_rl_env
from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl.checkpoint import (load_flax_tree, params_from_flax,
                                            params_to_flax, save_flax_tree)
from toybox_tpu_torch.rl.distributions import pd_from_logits
from toybox_tpu_torch.rl.policies import (RECURRENT_NETWORKS, build_policy,
                                          noise_step)
from toybox_tpu_torch.utils.checkpoint import Checkpointer

F32 = torch.float32
METRICS = ("policy_loss", "value_loss", "policy_entropy", "approxkl",
           "clipfrac")


# ---------------------------------------------------------------------------
# The optimizer: optax clip_by_global_norm -> scale_by_adam -> scale(-lr)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    """optax ``scale_by_adam`` state: first and second moments, and the
    step count."""
    mu: list
    nu: list
    count: int = 0

    @classmethod
    def zeros_like(cls, params) -> "AdamState":
        return cls(mu=[torch.zeros_like(p) for p in params],
                   nu=[torch.zeros_like(p) for p in params])


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: scale every gradient by max_norm / norm
    when the global norm reaches max_norm (``(g / norm) * max_norm``, no
    epsilon, unlike torch's clip_grad_norm_)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


@torch.no_grad()
def adam_update(params: list, grads: list, state: AdamState, lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-5,
                apply_step: bool = True) -> None:
    """One optax scale_by_adam step scaled by -lr, applied in place:
    mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, then
    p += (-(mu_hat / (sqrt(nu_hat) + eps))) * lr. Without ``apply_step``
    the moments and the count advance and the parameters stay (a step
    masked to zero, as DDPG's actor before learning_starts)."""
    state.count += 1
    c1 = 1.0 - np.float32(b1) ** np.float32(state.count)
    c2 = 1.0 - np.float32(b2) ** np.float32(state.count)
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
        if apply_step:
            step = (mu / float(c1)) / (torch.sqrt(nu / float(c2)) + eps)
            p.add_(-step * lr)


@dataclasses.dataclass
class RmsState:
    """optax ``scale_by_rms`` state: the second moment, starting at 0."""
    nu: list

    @classmethod
    def zeros_like(cls, params) -> "RmsState":
        return cls(nu=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def rms_update(params: list, grads: list, state: RmsState, lr,
               decay: float = 0.99, eps: float = 1e-5) -> None:
    """One optax scale_by_rms step (no bias correction, eps inside the
    root), then scale(-1) and the lr, applied in place:
    nu = (1-decay) g^2 + decay nu, p += (-(g * rsqrt(nu + eps))) * lr.
    (torch.optim.RMSprop divides by sqrt(nu) + eps: other steps.)"""
    for p, g, nu in zip(params, grads, state.nu):
        nu.copy_((1.0 - decay) * (g * g) + decay * nu)
        p.add_(-(g * torch.rsqrt(nu + eps)) * lr)


@dataclasses.dataclass
class MomentumState:
    """optax ``sgd(1.0, momentum)`` state: the trace of past updates."""
    trace: list

    @classmethod
    def zeros_like(cls, params) -> "MomentumState":
        return cls(trace=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def momentum_update(params: list, grads: list, state: MomentumState, scale,
                    momentum: float = 0.9) -> None:
    """One optax sgd(1.0, momentum) step scaled by ``scale``, in place:
    t = g + momentum t, p += scale * (-t)."""
    for p, g, t in zip(params, grads, state.trace):
        t.copy_(g + momentum * t)
        p.add_(scale * -t)


# ---------------------------------------------------------------------------
# Rollout, GAE, loss, update
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rollout:
    """nsteps of experience, time-major [nsteps, num_envs, ...]."""
    obs: torch.Tensor
    actions: torch.Tensor
    values: torch.Tensor
    neglogps: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    ep_ret: torch.Tensor
    ep_len: torch.Tensor

    @classmethod
    def empty(cls, nsteps: int, num_envs: int, obs: torch.Tensor):
        dev = obs.device

        def f(dtype):
            return torch.empty((nsteps, num_envs), dtype=dtype, device=dev)

        return cls(obs=torch.empty((nsteps,) + tuple(obs.shape),
                                   dtype=obs.dtype, device=dev),
                   actions=f(torch.int64), values=f(F32), neglogps=f(F32),
                   rewards=f(F32), dones=f(torch.bool), ep_ret=f(F32),
                   ep_len=f(torch.int32))


def rollout(step_fn, env_fns, env_state, generator: torch.Generator,
            buf: Rollout):
    """Fill ``buf`` with len(buf.obs) env steps under the policy; returns
    the env state after them."""
    for t in range(buf.obs.shape[0]):
        obs = env_state.frames
        buf.obs[t].copy_(obs)
        actions, values, neglogps, _ = step_fn(obs, generator)
        env_state, _, rewards, dones, info = env_fns.step(env_state, actions)
        buf.actions[t] = actions
        buf.values[t] = values
        buf.neglogps[t] = neglogps
        buf.rewards[t] = rewards
        buf.dones[t] = dones
        buf.ep_ret[t] = info["episode_return"]
        buf.ep_len[t] = info["episode_length"]
    return env_state


def gae(values: torch.Tensor, rewards: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float, lam: float) -> torch.Tensor:
    """GAE(lambda) advantages [nsteps, N], a backward loop over time; a
    step's ``nonterm`` comes from its own done, as in the JAX scan."""
    advs = torch.empty_like(values)
    next_adv, next_value = torch.zeros_like(last_value), last_value
    for t in range(values.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t].to(F32)
        delta = rewards[t] + gamma * next_value * nonterm - values[t]
        next_adv = delta + gamma * lam * nonterm * next_adv
        next_value = values[t]
        advs[t] = next_adv
    return advs


def normalize(advs: torch.Tensor) -> torch.Tensor:
    """(a - mean) / (std + 1e-8), std with ddof 0 as jnp.std."""
    return (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)


def ppo_loss(module, mb, clipr: float, ent_coef: float, vf_coef: float,
             num_actions: int, normalize_adv: bool = True, mean=None):
    """(loss, metrics) of a minibatch (obs, actions, old values, old
    neglogps, returns, advantages), as the JAX ``_loss``. ``mean`` takes
    the place of each per-row mean (a rank's share of a minibatch spread
    over a mesh: its rows' sum over the minibatch's size)."""
    obs, actions, old_values, old_neglogps, returns, advs = mb
    if mean is None:
        def mean(x):
            return x.mean()
    logits, vpred = module(obs)
    pd = pd_from_logits(num_actions, logits)
    neglogp = pd.neglogp(actions)
    entropy = mean(pd.entropy())

    vpredclipped = old_values + torch.clamp(vpred - old_values, -clipr, clipr)
    vf_loss = 0.5 * mean(torch.maximum(torch.square(vpred - returns),
                                       torch.square(vpredclipped - returns)))

    ratio = torch.exp(old_neglogps - neglogp)
    if normalize_adv:
        advs = normalize(advs)
    pg_loss = mean(torch.maximum(
        -advs * ratio,
        -advs * torch.clamp(ratio, 1.0 - clipr, 1.0 + clipr)))

    approxkl = 0.5 * mean(torch.square(neglogp - old_neglogps))
    clipfrac = mean(((ratio - 1.0).abs() > clipr).to(F32))
    loss = pg_loss - entropy * ent_coef + vf_loss * vf_coef
    return loss, dict(policy_loss=pg_loss, value_loss=vf_loss,
                      policy_entropy=entropy, approxkl=approxkl,
                      clipfrac=clipfrac)


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The loss and optimizer settings of one make_ppo."""
    nminibatches: int = 4
    microbatches: int = 1
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5


def update(module, adam: AdamState, batch: tuple, perms: list, lrnow: float,
           cliprnow: float, hp: Hyper, num_actions: int, mesh=None) -> dict:
    """The minibatch epochs of one PPO update, in place on ``module`` and
    ``adam``. batch: flat [nbatch, ...] (obs, actions, values, neglogps,
    returns, advs); perms: one permutation of range(nbatch) per epoch.
    Returns the mean of each metric over every minibatch (detached
    tensors).

    Each minibatch's advantages are normalised over the whole minibatch.
    Its rows are then split into equal shares, one for each rank of
    ``mesh`` (the whole minibatch for one process), and each share into
    ``hp.microbatches`` chunks; each chunk's per-row means become its
    rows' sums over the minibatch's size, so that one all-reduce of the
    summed gradients and metrics gives the minibatch's mean, the same on
    every rank. The clip and Adam act on that gradient, so the update is
    the one-process update up to the order of its sums. Every rank of a
    mesh holds the whole batch (``make_ppo`` gathers it)."""
    from toybox_tpu_torch.parallel.mesh import SINGLE, all_reduce_tensors
    mesh = SINGLE if mesh is None else mesh
    params = [p for p in module.parameters()]
    nbatch = batch[0].shape[0]
    mbsize = nbatch // hp.nminibatches
    share = mbsize // mesh.size
    ubsize = share // hp.microbatches
    sums = {k: torch.zeros((), device=batch[1].device) for k in METRICS}

    def mean(x):
        return x.sum() / mbsize

    for perm in perms:
        for i in range(hp.nminibatches):
            idx = perm[i * mbsize:(i + 1) * mbsize]
            mb_advs = normalize(batch[-1][idx])
            grads, metrics = None, None
            for j in range(hp.microbatches):
                sl = slice(mesh.rank * share + j * ubsize,
                           mesh.rank * share + (j + 1) * ubsize)
                ub = (tuple(x[idx[sl]] for x in batch[:-1])
                      + (mb_advs[sl],))
                loss, m = ppo_loss(module, ub, cliprnow, hp.ent_coef,
                                   hp.vf_coef, num_actions,
                                   normalize_adv=False, mean=mean)
                g = torch.autograd.grad(loss, params)
                grads = g if grads is None else [
                    a + b for a, b in zip(grads, g)]
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in m}
            *grads, msum = all_reduce_tensors(
                list(grads) + [torch.stack([metrics[k].detach()
                                            for k in METRICS])], mesh)
            grads = clip_by_global_norm(grads, hp.max_grad_norm)
            adam_update(params, grads, adam, lrnow)
            for k, v in zip(METRICS, msum):
                sums[k] += v
    n = len(perms) * hp.nminibatches
    return {k: v / n for k, v in sums.items()}


def anneal(update_count: int, total_updates: int, lr: float,
           cliprange: float, floor: float = 0.01) -> tuple:
    """(lrnow, cliprnow) as f32 values: both scaled by
    frac = max(1 - update/total_updates, floor), computed in f32 as the
    JAX train_step computes it (floor 0.01; acktr's is 0.05)."""
    f32 = np.float32
    frac = np.maximum(f32(1.0) - f32(update_count) / f32(max(total_updates,
                                                            1)), f32(floor))
    return float(f32(lr) * frac), float(f32(cliprange) * frac)


def episode_metrics(buf: Rollout, mesh=None) -> dict:
    """eprewmean, eplenmean (NaN without a finished episode), episodes and
    mean_reward of a rollout, as the JAX train_step reports them, over
    every rank's rollout of ``mesh`` (one process's without one)."""
    from toybox_tpu_torch.parallel.mesh import all_reduce
    done = ~torch.isnan(buf.ep_ret)
    ret = torch.where(done, buf.ep_ret, torch.zeros_like(buf.ep_ret)).sum()
    length = torch.where(done, buf.ep_len, torch.zeros_like(buf.ep_len))
    sums = all_reduce(torch.stack([
        done.to(F32).sum(), ret, length.sum().to(F32), buf.rewards.sum(),
        torch.full((), float(buf.rewards.numel()), device=ret.device)]),
        mesh)
    n = sums[0]
    nan = torch.full((), float("nan"), device=n.device)
    return dict(eprewmean=torch.where(n > 0, sums[1] / n, nan),
                eplenmean=torch.where(n > 0, sums[2] / n, nan),
                episodes=n, mean_reward=sums[3] / sums[4])


# ---------------------------------------------------------------------------
# make_ppo
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PPOState:
    """The whole training state; train_step updates it in place."""
    module: torch.nn.Module      # the policy (its parameters)
    adam: AdamState
    env_state: Any
    generator: torch.Generator   # actions and epoch permutations
    update: int = 0

    def state_dict(self) -> dict:
        return {"params": self.module.state_dict(), "mu": self.adam.mu,
                "nu": self.adam.nu, "count": self.adam.count,
                "env_state": self.env_state,
                "generator": self.generator.get_state(),
                "update": self.update}

    def load_state_dict(self, d: dict) -> None:
        self.module.load_state_dict(d["params"])
        self.adam = AdamState(mu=list(d["mu"]), nu=list(d["nu"]),
                              count=int(d["count"]))
        self.env_state = d["env_state"]
        self.generator.set_state(d["generator"])
        self.update = int(d["update"])


class TrainStep(NamedTuple):
    """One PPO update, ``train_step(state) -> (state, metrics)``, made of
    its two halves: ``collect(state) -> (batch, rollout)`` and
    ``optimize(state, (batch, rollout)) -> (state, metrics)``."""
    collect: Callable
    optimize: Callable

    def __call__(self, state: PPOState):
        return self.optimize(state, self.collect(state))


def make_ppo(env_fns, *, network="cnn", lr=2.5e-4, cliprange=0.1,
             nsteps=128, nminibatches=4, noptepochs=4, gamma=0.99,
             lam=0.95, ent_coef=0.01, vf_coef=0.5, max_grad_norm=0.5,
             total_updates=1, network_kwargs=None, microbatches=1,
             device="cuda", mesh=None):
    """Build (init_fn, train_step, act_fn) over a batched env whose
    tensors lie on ``device``.

    - init_fn(seed) -> PPOState: the policy initialised from ``seed`` (as
      flax initialises it), zero Adam moments, the envs reset with seeds
      drawn from the state's generator;
    - train_step(state) -> (state, metrics): one nsteps rollout, GAE and
      noptepochs x nminibatches Adam steps, in place; a TrainStep whose
      two halves, ``collect`` and ``optimize``, can be timed apart;
    - act_fn(state, obs) -> (actions, values, neglogps, logits).

    ``microbatches`` splits each minibatch's gradient into that many
    chunks summed before the one Adam step (advantages normalised over the
    full minibatch first), as the JAX package does to bound memory.

    With a ``mesh`` (``parallel.mesh.make_mesh``) ``env_fns`` holds this
    rank's block of the mesh's envs (built with ``seed_stride`` = all of
    them, so that its auto-resets reseed as one process's envs do), and
    the update is the update of all of them, as one process would make it
    (up to the order of sums): every random draw is made for the whole
    env set, alike on every rank (the env seeds and the Gumbel noise of
    each step, whose rows of this block the rank takes, and each epoch's
    permutation); the rollout is gathered onto every rank, and each rank
    takes its share of every minibatch (``update``)."""
    from toybox_tpu_torch.parallel.mesh import all_gather_rows, env_block
    if network in RECURRENT_NETWORKS:
        raise ValueError(f"recurrent network {network!r}: use "
                         "ppo_recurrent.make_recurrent_ppo (learn "
                         "dispatches to it)")
    num_envs = env_fns.num_envs
    envs = env_block(mesh, num_envs)
    nbatch = envs.n_global * nsteps
    if nbatch % nminibatches or (nbatch // nminibatches) % (
            envs.mesh.size * microbatches):
        raise ValueError(f"{nbatch} samples do not split into "
                         f"{nminibatches} minibatches of "
                         f"{envs.mesh.size} x {microbatches} equal chunks")
    dev = torch.device(device)
    hp = Hyper(nminibatches=nminibatches, microbatches=microbatches,
               ent_coef=ent_coef, vf_coef=vf_coef,
               max_grad_norm=max_grad_norm)
    module, p_init, _, p_value = build_policy(
        env_fns.obs_shape, env_fns.num_actions, network, device=dev,
        **(network_kwargs or {}))
    p_step = noise_step(module, rows=envs)      # a discrete action space
    storage = {}

    def init_fn(seed: int = 0) -> PPOState:
        p_init(seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = envs.take(torch.randint(0, 2**31 - 1, (envs.n_global,),
                                        generator=gen, device=dev))
        env_state, _ = env_fns.reset(seeds)
        return PPOState(module=module,
                        adam=AdamState.zeros_like(list(module.parameters())),
                        env_state=env_state, generator=gen)

    def collect(state: PPOState):
        """The rollout half: nsteps env steps, then GAE; returns the
        flat batch and the rollout."""
        obs0 = state.env_state.frames
        if "buf" not in storage:
            storage["buf"] = Rollout.empty(nsteps, num_envs, obs0)
        buf = storage["buf"]
        state.env_state = rollout(p_step, env_fns, state.env_state,
                                  state.generator, buf)
        last_value = p_value(state.env_state.frames)
        advs = gae(buf.values, buf.rewards, buf.dones, last_value, gamma,
                   lam)
        returns = advs + buf.values

        def flat(x):        # [nsteps, envs of every rank, ...] flattened
            x = all_gather_rows(x, mesh, dim=1)
            return x.reshape((nbatch,) + tuple(x.shape[2:]))

        return tuple(map(flat, (buf.obs, buf.actions, buf.values,
                                buf.neglogps, returns, advs))), buf

    def optimize(state: PPOState, collected):
        """The epochs half: noptepochs permutations, the minibatch Adam
        steps and the update's metrics."""
        batch, buf = collected
        lrnow, cliprnow = anneal(state.update, total_updates, lr, cliprange)
        perms = [torch.randperm(nbatch, generator=state.generator,
                                device=dev) for _ in range(noptepochs)]
        metrics = update(module, state.adam, batch, perms, lrnow, cliprnow,
                         hp, env_fns.num_actions, mesh)
        metrics.update(episode_metrics(buf, mesh))
        state.update += 1
        return state, metrics

    def act_fn(state: PPOState, obs: torch.Tensor):
        return p_step(obs, state.generator)

    return init_fn, TrainStep(collect, optimize), act_fn


# ---------------------------------------------------------------------------
# learn() -- the host training loop (reference ppo2.learn surface)
# ---------------------------------------------------------------------------

def learn(*, env=None, game="breakout", num_envs=8, total_timesteps=10_000,
          seed=0, network="cnn", nsteps=128, nminibatches=4, noptepochs=4,
          lr=2.5e-4, cliprange=0.1, gamma=0.99, lam=0.95, ent_coef=0.01,
          vf_coef=0.5, max_grad_norm=0.5, log_interval=1, save_path=None,
          load_path=None, logger=None, mesh=None, network_kwargs=None,
          checkpoint_path=None, checkpoint_freq=50, microbatches=1,
          device="cuda", **extra):
    """Train PPO for total_timesteps env frames; returns the PPOState.

    Without ``env`` it builds ``make_rl_env(game, num_envs,
    inkernel_warp=True)`` on ``device`` for a game with a frame kernel:
    each step's frame is warped inside the fused frame kernel, which on
    the H100 takes less time than the fused kernel and two matmuls
    (PERF.md); Gridworld's frames take the plain render and the matmul
    warp. TF32 is turned off, as the JAX reference computes in f32. A
    recurrent network (lstm, cnn_lstm, cnn_lnlstm) trains with
    ``ppo_recurrent.learn``, as in JAX.

    ``mesh`` (``parallel.mesh.make_mesh`` over the process group) makes
    the update data-parallel (``make_ppo``): ``num_envs`` counts the envs
    of the whole mesh and each rank builds its block of them (an ``env``
    handed in is this rank's block, built with ``seed_stride`` = the
    mesh's env count); the params are broadcast from the
    first rank (``replicate``); only the first rank saves, and each rank
    checkpoints under ``rank<r>`` of ``checkpoint_path``. A recurrent
    network under ``mesh`` raises ValueError: JAX routes it to
    ``ppo_recurrent.learn``, which takes no mesh."""
    if mesh is not None and network in RECURRENT_NETWORKS:
        raise ValueError(f"mesh=: the recurrent network {network!r} trains "
                         "with ppo_recurrent.learn, which takes no mesh")
    if network in RECURRENT_NETWORKS:
        from toybox_tpu_torch.rl.ppo_recurrent import learn as rlearn
        return rlearn(env=env, game=game, num_envs=num_envs,
                      total_timesteps=total_timesteps, seed=seed,
                      network=network, nsteps=nsteps,
                      nminibatches=nminibatches, noptepochs=noptepochs,
                      lr=lr, cliprange=cliprange, gamma=gamma, lam=lam,
                      ent_coef=ent_coef, vf_coef=vf_coef,
                      max_grad_norm=max_grad_norm,
                      log_interval=log_interval, save_path=save_path,
                      load_path=load_path, logger=logger,
                      network_kwargs=network_kwargs, device=device, **extra)
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    ranks, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    if env is None and num_envs % ranks:
        raise ValueError(f"{num_envs} envs do not split over {ranks} ranks")
    env_fns = env if env is not None else make_rl_env(
        game, num_envs // ranks, inkernel_warp=game in FRAME_KERNEL_GAMES,
        seed_stride=num_envs, device=device)
    nbatch = env_fns.num_envs * ranks * nsteps
    fpstep = getattr(env_fns, "frames_per_step", 1)
    total_updates = max(int(total_timesteps) // (nbatch * fpstep), 1)

    init_fn, train_step, _ = make_ppo(
        env_fns, network=network, lr=lr, cliprange=cliprange, nsteps=nsteps,
        nminibatches=nminibatches, noptepochs=noptepochs, gamma=gamma,
        lam=lam, ent_coef=ent_coef, vf_coef=vf_coef,
        max_grad_norm=max_grad_norm, total_updates=total_updates,
        network_kwargs=network_kwargs, microbatches=microbatches,
        device=device, mesh=mesh)
    state = init_fn(seed)
    if load_path is not None:
        load_params(load_path, state.module)
    if mesh is not None:
        from toybox_tpu_torch.parallel.mesh import replicate
        replicate(list(state.module.parameters()), mesh)
        if checkpoint_path is not None and ranks > 1:
            checkpoint_path = os.path.join(checkpoint_path, f"rank{rank}")

    ckpt = Checkpointer(checkpoint_path, checkpoint_freq)
    state = ckpt.restore(state)   # resume from the latest ckpt_<n> if any
    start_update = state.update

    t0 = time.perf_counter()
    for update_count in range(start_update + 1, total_updates + 1):
        state, metrics = train_step(state)
        if logger is not None and update_count % log_interval == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            elapsed = time.perf_counter() - t0
            logger.logkv("misc/serial_timesteps", update_count * nsteps)
            logger.logkv("misc/nupdates", update_count)
            logger.logkv("misc/total_timesteps",
                         update_count * nbatch * fpstep)
            logger.logkv("fps", int((update_count - start_update) * nbatch
                                    * fpstep / elapsed))
            for k, v in metrics.items():
                logger.logkv(f"loss/{k}" if k in METRICS else k, v)
            logger.dumpkvs()
        ckpt.maybe_save(state, update_count)
    if save_path is not None and rank == 0:
        save_params(save_path, state.module)
    return state


def save_params(path, module: torch.nn.Module) -> None:
    """Write the policy as flax ``to_bytes`` writes its params, so that the
    JAX ``ppo.load_params`` reads it."""
    save_flax_tree(path, params_to_flax(module.state_dict()))


def load_params(path, module: torch.nn.Module) -> torch.nn.Module:
    """Load a flax params file (JAX ``ppo.save_params``, or
    ``save_params`` here) into the policy ``module``."""
    module.load_state_dict(params_from_flax(load_flax_tree(path)))
    return module


# ---------------------------------------------------------------------------
# Multi-rank dry run (the port's parallel.dryrun.dryrun_multichip)
# ---------------------------------------------------------------------------

def dryrun(n_devices: int, game: str = "breakout", device="cuda",
           sharded: bool = True):
    """One full PPO update on tiny shapes (2 envs a rank, nsteps 4,
    cnn_small), data-parallel over a mesh of the process group's
    ``n_devices`` ranks (``sharded``), or without a mesh, the same update
    of the same global env set in one process. The env is built as the
    JAX dryrun builds it (``make_rl_env`` at 84, the fused max-pool kernel
    and the matmul warp). Returns (state, metrics)."""
    from toybox_tpu_torch.parallel.dryrun import dryrun_mesh
    from toybox_tpu_torch.parallel.mesh import replicate
    full_f32()
    mesh = dryrun_mesh(n_devices, sharded)
    ranks = mesh.size if sharded else 1
    env_fns = make_rl_env(game, 2 * n_devices // ranks, frame_size=84,
                          seed_stride=2 * n_devices, device=device)
    init_fn, train_step, _ = make_ppo(env_fns, nsteps=4, nminibatches=2,
                                      noptepochs=1, network="cnn_small",
                                      device=device, mesh=mesh)
    state = init_fn(0)
    if mesh is not None:
        replicate(list(state.module.parameters()), mesh)
    return train_step(state)

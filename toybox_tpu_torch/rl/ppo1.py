"""PPO1 (pposgd), the original PPO recipe (port of toybox_tpu.rl.ppo1:
``ObFilter``, ``make_ppo1`` and ``learn``).

The semantics are the JAX package's (the reference ppo1/pposgd_simple),
which differ from ppo2's:

- an explicit old policy: a frozen copy of the policy, taken before each
  update's epochs; the ratio and the KL are computed against it, under
  the observation filter as updated with this update's batch;
- no value clipping: the loss is pol_surr + pol_entpen + vf_loss, the
  value loss a plain mean square (no 0.5);
- advantages standardised over the whole batch before the minibatches;
- the clip parameter and the Adam step size both scaled by ``lrmult``
  ('constant' or 'linear' over the updates);
- with ``normalize_observations`` (the default for mlp) a running
  mean/std filter of the observations, clipped to +-5 sigma, updated once
  an update with the fresh batch;
- optionally (``kl_targ``) the adaptive KL penalty beta * KL(old, new),
  beta doubled or halved when the mean KL leaves [targ/1.5, 1.5 targ].

Adam is optax.chain(scale_by_adam(eps=adam_epsilon), scale(-1)) scaled by
the lr after it (``ppo.adam_update``). An update is a ``ppo.TrainStep``;
``collect(state, draws=None)`` and ``optimize(state, collected,
draws=None)`` take their random draws (the actions' Gumbel noise, the
epochs' permutations) from the state's generator unless a caller hands
them in. The old policy's logits are computed once an update, in
minibatch-sized chunks: its parameters and the filter are fixed across
the epochs.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from toybox_tpu_torch.envs.pipeline import FRAME_KERNEL_GAMES, make_rl_env
from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.distributions import pd_from_logits
from toybox_tpu_torch.rl.policies import build_policy, noise_step

F32 = torch.float32
METRICS = ("pol_surr", "pol_entpen", "vf_loss", "kl", "ent")


@dataclasses.dataclass
class ObFilter:
    """Running mean and variance of the observations (mlp_policy's
    ob_rms), the count starting at 1e-4."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor          # f32 scalar

    @classmethod
    def create(cls, shape, device="cuda") -> "ObFilter":
        return cls(mean=torch.zeros(shape, dtype=F32, device=device),
                   var=torch.ones(shape, dtype=F32, device=device),
                   count=torch.full((), 1e-4, dtype=F32, device=device))

    def update(self, batch: torch.Tensor) -> "ObFilter":
        """The parallel (Welford) merge with the batch's moments, the
        batch variance the population one."""
        bmean = batch.mean(0)
        bvar = batch.var(0, correction=0)
        bcount = torch.full((), batch.shape[0], dtype=F32,
                            device=batch.device)
        delta = bmean - self.mean
        tot = self.count + bcount
        mean = self.mean + delta * bcount / tot
        m2 = (self.var * self.count + bvar * bcount
              + torch.square(delta) * self.count * bcount / tot)
        return ObFilter(mean=mean, var=m2 / tot, count=tot)

    def normalize(self, obs: torch.Tensor) -> torch.Tensor:
        std = torch.sqrt(self.var + 1e-8)
        return torch.clamp((obs.to(F32) - self.mean) / std, -5.0, 5.0)


@dataclasses.dataclass
class PPO1State:
    """The whole training state; train_step updates it in place."""
    module: torch.nn.Module      # the policy
    old: torch.nn.Module         # the old policy (frozen; assign_old_eq_new)
    adam: ppo.AdamState
    env_state: Any
    ob_rms: ObFilter
    kl_beta: torch.Tensor        # f32 scalar, the adaptive KL coefficient
    generator: torch.Generator   # actions and epoch permutations
    update: int = 0


def lrmult(schedule: str, update: int, total_updates: int) -> float:
    """The f32 multiplier of the clip parameter and the step size at
    ``update`` (the count before this update): 1, or
    max(1 - update / total_updates, 0)."""
    f32 = np.float32
    if schedule == "constant":
        return 1.0
    if schedule == "linear":
        return float(np.maximum(f32(1.0) - f32(update)
                                / f32(max(total_updates, 1)), f32(0.0)))
    raise NotImplementedError(schedule)


def ppo1_loss(module, old_logits, mb, clipr: float, entcoeff: float,
              beta, kl_targ, num_actions):
    """(total, metrics) of a minibatch (obs, actions, advs, vtargs) whose
    obs are already filtered, as the JAX ``_loss``."""
    obs, actions, advs, vtargs = mb
    logits, vpred = module(obs)
    pd = pd_from_logits(num_actions, logits)
    old_pd = pd_from_logits(num_actions, old_logits)
    kl = old_pd.kl(pd).mean()
    ent = pd.entropy().mean()
    pol_entpen = -entcoeff * ent
    ratio = torch.exp(old_pd.neglogp(actions) - pd.neglogp(actions))
    surr1 = ratio * advs
    surr2 = torch.clamp(ratio, 1.0 - clipr, 1.0 + clipr) * advs
    pol_surr = -torch.minimum(surr1, surr2).mean()
    vf_loss = torch.square(vpred - vtargs).mean()
    total = pol_surr + pol_entpen + vf_loss
    if kl_targ is not None:
        total = total + beta * kl
    return total, dict(pol_surr=pol_surr, pol_entpen=pol_entpen,
                       vf_loss=vf_loss, kl=kl, ent=ent)


def make_ppo1(env_fns, *, network="cnn", timesteps_per_actorbatch=256,
              clip_param=0.2, entcoeff=0.01, optim_epochs=4,
              optim_stepsize=1e-3, optim_batchsize=64, gamma=0.99,
              lam=0.95, schedule="linear", adam_epsilon=1e-5,
              total_updates=1, kl_targ=None, normalize_observations=None,
              network_kwargs=None, device="cuda"):
    """Build (init_fn, train_step) over a batched env whose tensors lie on
    ``device``. ``timesteps_per_actorbatch`` is the per-env horizon.

    - init_fn(seed) -> PPO1State: the policy initialised as flax does from
      ``seed``, the old policy a copy, zero Adam moments, an empty filter
      (mean 0, var 1, count 1e-4), beta 1, the envs reset with seeds drawn
      from the state's generator;
    - train_step(state) -> (state, metrics), a ppo.TrainStep:
      ``collect(state, draws=None)`` the rollout under the policy and the
      filter as they are (draws: ``gumbel`` [nsteps, N, n_actions]), GAE,
      vtarg = adv + v; ``optimize(state, collected, draws=None)`` the
      filter's update, the old policy's snapshot and the epochs (draws:
      ``perms`` [optim_epochs, nbatch])."""
    dev = torch.device(device)
    num_envs, nact = env_fns.num_envs, env_fns.num_actions
    nsteps = timesteps_per_actorbatch
    nbatch = num_envs * nsteps
    optim_batchsize = min(optim_batchsize, nbatch)
    n_minibatches = nbatch // optim_batchsize
    if normalize_observations is None:
        normalize_observations = network == "mlp"
    module, p_init, _, _ = build_policy(
        env_fns.obs_shape, nact, network, device=dev,
        **(network_kwargs or {}))
    old = copy.deepcopy(module).requires_grad_(False)
    storage = {}

    def filtered(ob_rms: ObFilter, obs: torch.Tensor) -> torch.Tensor:
        return ob_rms.normalize(obs) if normalize_observations else obs

    def init_fn(seed: int = 0) -> PPO1State:
        p_init(seed)
        old.load_state_dict(module.state_dict())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = torch.randint(0, 2**31 - 1, (num_envs,), generator=gen,
                              device=dev)
        env_state, _ = env_fns.reset(seeds)
        return PPO1State(
            module=module, old=old,
            adam=ppo.AdamState.zeros_like(list(module.parameters())),
            env_state=env_state,
            ob_rms=ObFilter.create(tuple(env_fns.obs_shape), dev),
            kl_beta=torch.ones((), dtype=F32, device=dev), generator=gen)

    def collect(state: PPO1State, draws: dict | None = None):
        """The rollout half: returns (the flat batch, the rollout)."""
        if "buf" not in storage:
            storage["buf"] = ppo.Rollout.empty(nsteps, num_envs,
                                               state.env_state.frames)
        buf, ob_rms = storage["buf"], state.ob_rms
        noise = iter(draws["gumbel"]) if draws is not None else None
        state.env_state = ppo.rollout(
            noise_step(lambda obs: module(filtered(ob_rms, obs)), noise),
            env_fns, state.env_state, state.generator, buf)
        with torch.no_grad():
            last_value = module(filtered(ob_rms,
                                         state.env_state.frames))[1]
        advs = ppo.gae(buf.values, buf.rewards, buf.dones, last_value,
                       gamma, lam)
        vtargs = advs + buf.values

        def flat(x):
            return x.reshape((nbatch,) + tuple(x.shape[2:]))

        return (flat(buf.obs), flat(buf.actions), flat(advs),
                flat(vtargs)), buf

    def optimize(state: PPO1State, collected, draws: dict | None = None):
        """The epochs half: the filter's update, assign_old_eq_new, the
        minibatch Adam steps, beta's adaptation and the metrics."""
        (obs, actions, advs, vtargs), buf = collected
        mult = lrmult(schedule, state.update, total_updates)
        clipr = float(np.float32(clip_param) * np.float32(mult))
        lr = float(np.float32(optim_stepsize) * np.float32(mult))
        advs = ppo.normalize(advs)
        if normalize_observations:
            state.ob_rms = state.ob_rms.update(obs.to(F32))
        state.old.load_state_dict(state.module.state_dict())
        with torch.no_grad():
            old_logits = torch.cat([
                state.old(filtered(state.ob_rms,
                                   obs[i:i + optim_batchsize]))[0]
                for i in range(0, nbatch, optim_batchsize)])
        perms = (draws["perms"] if draws is not None else torch.stack([
            torch.randperm(nbatch, generator=state.generator,
                           device=obs.device)
            for _ in range(optim_epochs)]))
        params = list(state.module.parameters())
        sums = {k: torch.zeros((), device=obs.device) for k in METRICS}
        for perm in perms:
            for i in range(n_minibatches):
                idx = perm[i * optim_batchsize:(i + 1) * optim_batchsize]
                mb = (filtered(state.ob_rms, obs[idx]), actions[idx],
                      advs[idx], vtargs[idx])
                total, m = ppo1_loss(state.module, old_logits[idx], mb,
                                     clipr, entcoeff, state.kl_beta,
                                     kl_targ, nact)
                grads = torch.autograd.grad(total, params)
                ppo.adam_update(params, grads, state.adam, lr,
                                eps=adam_epsilon)
                for k in METRICS:
                    sums[k] += m[k].detach()
        metrics = {k: v / (len(perms) * n_minibatches)
                   for k, v in sums.items()}
        if kl_targ is not None:
            beta = state.kl_beta
            state.kl_beta = torch.where(
                metrics["kl"] > 1.5 * kl_targ, beta * 2.0,
                torch.where(metrics["kl"] < kl_targ / 1.5, beta * 0.5, beta))
        metrics.update(ppo.episode_metrics(buf))
        state.update += 1
        return state, metrics

    return init_fn, ppo.TrainStep(collect, optimize)


def learn(*, env=None, game="breakout", num_envs=8, total_timesteps=10_000,
          seed=0, network="cnn", timesteps_per_actorbatch=256,
          clip_param=0.2, entcoeff=0.01, optim_epochs=4, optim_stepsize=1e-3,
          optim_batchsize=64, gamma=0.99, lam=0.95, schedule="linear",
          kl_targ=None, log_interval=1, save_path=None, load_path=None,
          logger=None, network_kwargs=None, device="cuda", **extra):
    """Train PPO1 for total_timesteps env frames; returns the PPO1State.
    run.py's ppo-style names are accepted for the pposgd ones (nsteps,
    cliprange, ent_coef, noptepochs, lr). The env is built as
    ``ppo.learn`` builds it; TF32 is off. ``load_path`` loads into the
    policy and the old policy; each logged update's metrics are read to
    the host at once (the loss terms as ``loss_<name>``); ``save_path``
    writes the policy."""
    timesteps_per_actorbatch = extra.pop("nsteps", timesteps_per_actorbatch)
    clip_param = extra.pop("cliprange", clip_param)
    entcoeff = extra.pop("ent_coef", entcoeff)
    optim_epochs = extra.pop("noptepochs", optim_epochs)
    optim_stepsize = extra.pop("lr", optim_stepsize)
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    env_fns = env if env is not None else make_rl_env(
        game, num_envs, inkernel_warp=game in FRAME_KERNEL_GAMES,
        device=device)
    nbatch = env_fns.num_envs * timesteps_per_actorbatch
    fpstep = getattr(env_fns, "frames_per_step", 1)
    total_updates = max(int(total_timesteps) // (nbatch * fpstep), 1)
    init_fn, train_step = make_ppo1(
        env_fns, network=network,
        timesteps_per_actorbatch=timesteps_per_actorbatch,
        clip_param=clip_param, entcoeff=entcoeff, optim_epochs=optim_epochs,
        optim_stepsize=optim_stepsize, optim_batchsize=optim_batchsize,
        gamma=gamma, lam=lam, schedule=schedule, kl_targ=kl_targ,
        total_updates=total_updates, network_kwargs=network_kwargs,
        device=device)
    state = init_fn(seed)
    if load_path is not None:
        ppo.load_params(load_path, state.module)
        ppo.load_params(load_path, state.old)
    t0 = time.perf_counter()
    for update in range(1, total_updates + 1):
        state, metrics = train_step(state)
        if logger is not None and update % log_interval == 0:
            host = torch.stack([v.to(F32) for v in metrics.values()])
            logger.logkv("nupdates", update)
            logger.logkv("total_timesteps", update * nbatch * fpstep)
            logger.logkv("fps", int(update * nbatch * fpstep
                                    / (time.perf_counter() - t0)))
            for k, v in zip(metrics, host.tolist()):
                logger.logkv(f"loss_{k}" if k in METRICS else k, v)
            logger.dumpkvs()
    if save_path is not None:
        ppo.save_params(save_path, state.module)
    return state

"""TRPO, trust-region policy optimization by conjugate gradient (port of
toybox_tpu.rl.trpo: ``trust_region_update``, ``make_trpo`` and
``learn``).

The semantics are the JAX package's (the reference trpo_mpi): GAE(0.98)
advantages normalised over the batch, the surrogate gain, Fisher-vector
products as the gradient of (grad KL . v) at the old parameters,
conjugate gradient (10 iterations, damping 0.1), the step scaled to
KL = max_kl, a 10-step backtracking line search that keeps the first
candidate improving the surrogate by a tenth of the expected improvement
within 1.5 max_kl, and a separate value network fitted by ``vf_iters``
full-batch Adam steps (optax.adam(vf_stepsize), eps 1e-8).

The policy's parameters are raveled into one flat vector in the module's
parameter order (JAX ravels flax's sorted keys: the same values, summed
in another order) and the policy is evaluated at a flat vector with
``torch.func.functional_call``. Every line-search candidate is evaluated,
as JAX scans all ten, so the update reads nothing back from the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from toybox_tpu_torch.envs.pipeline import FRAME_KERNEL_GAMES, make_rl_env
from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.distributions import pd_from_logits
from toybox_tpu_torch.rl.policies import build_policy

F32 = torch.float32
METRICS = ("surrogate_gain", "kl", "accepted", "vf_loss", "entropy")


def trust_region_update(module, num_actions, fobs, facts, fadv, fnlp_old, *,
                        max_kl=0.001, cg_iters=10, cg_damping=0.1,
                        ent_coef=0.0, line_search_steps=10):
    """One KL-constrained natural-gradient step of the policy ``module``
    (its logits are ``module(obs)[0]``) on a flat batch, in place.
    Returns (metrics, search): metrics surrogate_gain, kl and accepted
    (f32) of the step taken; search the line search's record, each
    candidate's ``gains`` and ``kls`` [line_search_steps] beside ``gain0``
    and ``expected_improve``."""
    names = [n for n, _ in module.named_parameters()]
    shapes = [p.shape for _, p in module.named_parameters()]
    sizes = [p.numel() for _, p in module.named_parameters()]

    def logits_at(flat):
        params = {n: x.view(s) for n, x, s in
                  zip(names, torch.split(flat, sizes), shapes)}
        return functional_call(module, params, (fobs,))[0]

    with torch.no_grad():
        old = pd_from_logits(num_actions, module(fobs)[0])

    def surrogate(flat):
        pd = pd_from_logits(num_actions, logits_at(flat))
        ratio = torch.exp(fnlp_old - pd.neglogp(facts))
        return (ratio * fadv).mean() + ent_coef * pd.entropy().mean()

    def mean_kl(flat):
        return old.kl(pd_from_logits(num_actions, logits_at(flat))).mean()

    flat0 = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    x0 = flat0.clone().requires_grad_(True)
    g, = torch.autograd.grad(surrogate(x0), x0)
    kl_grad, = torch.autograd.grad(mean_kl(x0), x0, create_graph=True)

    def fvp(v):
        hv, = torch.autograd.grad(kl_grad @ v, x0, retain_graph=True)
        return hv + cg_damping * v

    x, r, p = torch.zeros_like(g), g, g
    rdr = r @ r
    for _ in range(cg_iters):
        ap = fvp(p)
        a = rdr / (p @ ap + 1e-10)
        x = x + a * p
        r = r - a * ap
        new_rdr = r @ r
        p = r + (new_rdr / (rdr + 1e-10)) * p
        rdr = new_rdr
    stepdir = x
    shs = 0.5 * (stepdir @ fvp(stepdir))
    del kl_grad
    lm = torch.sqrt(torch.clamp(shs / max_kl, min=1e-10))
    fullstep = stepdir / lm
    expected_improve = g @ fullstep

    with torch.no_grad():
        gain0 = surrogate(flat0)
        best, accepted = flat0, torch.zeros((), dtype=torch.bool,
                                            device=flat0.device)
        gains, kls = [], []
        for i in range(line_search_steps):
            stepfrac = float(np.float32(0.5) ** np.float32(i))
            cand = flat0 + stepfrac * fullstep
            gains.append(surrogate(cand))
            kls.append(mean_kl(cand))
            ok = ((gains[-1] - gain0 > 0.1 * stepfrac * expected_improve)
                  & (kls[-1] <= max_kl * 1.5) & ~accepted)
            best = torch.where(ok, cand, best)
            accepted = accepted | ok
        metrics = dict(surrogate_gain=surrogate(best) - gain0,
                       kl=mean_kl(best), accepted=accepted.to(F32))
        torch.nn.utils.vector_to_parameters(best, module.parameters())
    search = dict(gains=torch.stack(gains), kls=torch.stack(kls),
                  gain0=gain0, expected_improve=expected_improve.detach())
    return metrics, search


@dataclasses.dataclass
class TRPOState:
    """The whole training state; train_step updates it in place."""
    module: torch.nn.Module        # the policy
    vf: torch.nn.Module            # the value network (its V head)
    vf_adam: ppo.AdamState
    env_state: Any
    generator: torch.Generator     # the actions
    update: int = 0


def trpo_batch(buf: ppo.Rollout, last_value: torch.Tensor, gamma: float,
               lam: float, rewards: torch.Tensor | None = None) -> tuple:
    """The flat batch (obs, actions, normalised advantages, old
    neglogps, returns) of a rollout whose values are the value network's:
    GAE(lam) advantages of ``rewards`` [nsteps, N] (the rollout's unless
    given), returns = advantages + values."""
    advs = ppo.gae(buf.values, buf.rewards if rewards is None else rewards,
                   buf.dones, last_value, gamma, lam)
    returns = advs + buf.values

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    return (flat(buf.obs), flat(buf.actions), ppo.normalize(flat(advs)),
            flat(buf.neglogps), flat(returns))


def value_net_step(pi_step, vf_value):
    """A rollout step_fn: ``pi_step``'s actions, neglogps and logits with
    the separate value network's values."""

    def step_fn(obs, generator):
        actions, _, neglogps, logits = pi_step(obs, generator)
        return actions, vf_value(obs), neglogps, logits

    return step_fn


def fit_value(vf, adam: ppo.AdamState, fobs: torch.Tensor,
              fret: torch.Tensor, iters: int, lr: float) -> torch.Tensor:
    """``iters`` Adam steps (optax.adam: eps 1e-8) of the value network on
    mean (V - returns)^2, in place; the last step's loss."""
    params = list(vf.parameters())
    for _ in range(iters):
        loss = torch.square(vf(fobs)[1] - fret).mean()
        # the value network's pi head takes zero gradients, as in JAX
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        ppo.adam_update(params, grads, adam, lr, eps=1e-8)
    return loss.detach()


def make_trpo(env_fns, *, network="cnn_small", nsteps=512, gamma=0.99,
              lam=0.98, max_kl=0.001, cg_iters=10, cg_damping=0.1,
              vf_stepsize=3e-4, vf_iters=3, ent_coef=0.0,
              line_search_steps=10, network_kwargs=None, device="cuda"):
    """Build (init_fn, train_step) over a batched env whose tensors lie on
    ``device``:

    - init_fn(seed) -> TRPOState: the policy (PolicyWithValue, as flax
      initialises it, from ``seed``) and a value network of the same
      shape (from ``seed + 1``), zero Adam moments for the value network,
      the envs reset with seeds drawn from the state's generator;
    - train_step(state) -> (state, metrics), a ppo.TrainStep: ``collect``
      the nsteps rollout (values from the value network), returning
      ``trpo_batch`` and the rollout's eprewmean and mean_reward;
      ``optimize(state, (batch, roll_metrics))`` the trust-region step
      and the value fit."""
    dev = torch.device(device)
    num_envs, nact = env_fns.num_envs, env_fns.num_actions
    kw = network_kwargs or {}
    module, pi_init, pi_step, _ = build_policy(
        env_fns.obs_shape, nact, network, device=dev, **kw)
    vf, vf_init, _, vf_value = build_policy(
        env_fns.obs_shape, nact, network, device=dev, **kw)
    storage = {}

    def init_fn(seed: int = 0) -> TRPOState:
        pi_init(seed)
        vf_init(seed + 1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = torch.randint(0, 2**31 - 1, (num_envs,), generator=gen,
                              device=dev)
        env_state, _ = env_fns.reset(seeds)
        return TRPOState(module=module, vf=vf,
                         vf_adam=ppo.AdamState.zeros_like(
                             list(vf.parameters())),
                         env_state=env_state, generator=gen)

    step_fn = value_net_step(pi_step, vf_value)

    def collect(state: TRPOState):
        if "buf" not in storage:
            storage["buf"] = ppo.Rollout.empty(nsteps, num_envs,
                                               state.env_state.frames)
        buf = storage["buf"]
        state.env_state = ppo.rollout(step_fn, env_fns, state.env_state,
                                      state.generator, buf)
        ep = ppo.episode_metrics(buf)
        return trpo_batch(buf, vf_value(state.env_state.frames), gamma,
                          lam), {k: ep[k] for k in ("eprewmean",
                                                    "mean_reward")}

    def optimize(state: TRPOState, collected):
        (fobs, facts, fadv, fnlp_old, fret), roll_metrics = collected
        module, vf = state.module, state.vf
        metrics, _ = trust_region_update(
            module, nact, fobs, facts, fadv, fnlp_old, max_kl=max_kl,
            cg_iters=cg_iters, cg_damping=cg_damping, ent_coef=ent_coef,
            line_search_steps=line_search_steps)
        vf_loss = fit_value(vf, state.vf_adam, fobs, fret, vf_iters,
                            vf_stepsize)
        with torch.no_grad():
            entropy = pd_from_logits(nact, module(fobs)[0]).entropy().mean()
        metrics.update(vf_loss=vf_loss, entropy=entropy,
                       **roll_metrics)
        state.update += 1
        return state, metrics

    return init_fn, ppo.TrainStep(collect, optimize)


def learn(*, env=None, game="breakout", num_envs=8, total_timesteps=100_000,
          seed=0, network="cnn_small", nsteps=512, gamma=0.99, lam=0.98,
          max_kl=0.001, cg_iters=10, cg_damping=0.1, vf_stepsize=3e-4,
          vf_iters=3, ent_coef=0.0, log_interval=1, save_path=None,
          load_path=None, logger=None, network_kwargs=None, device="cuda",
          **extra):
    """Train TRPO for total_timesteps env frames; returns the TRPOState.
    The env is built as ``ppo.learn`` builds it; TF32 is off (the
    Fisher-vector products run double backward through the
    convolutions). Each update's metrics are read to the host at once,
    every ``log_interval`` updates. ``save_path`` writes the policy."""
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    env_fns = env if env is not None else make_rl_env(
        game, num_envs, inkernel_warp=game in FRAME_KERNEL_GAMES,
        device=device)
    nbatch = env_fns.num_envs * nsteps
    fpstep = getattr(env_fns, "frames_per_step", 1)
    total_updates = max(int(total_timesteps) // (nbatch * fpstep), 1)
    init_fn, train_step = make_trpo(
        env_fns, network=network, nsteps=nsteps, gamma=gamma, lam=lam,
        max_kl=max_kl, cg_iters=cg_iters, cg_damping=cg_damping,
        vf_stepsize=vf_stepsize, vf_iters=vf_iters, ent_coef=ent_coef,
        network_kwargs=network_kwargs, device=device)
    state = init_fn(seed)
    if load_path is not None:
        ppo.load_params(load_path, state.module)
    t0 = time.perf_counter()
    for update in range(1, total_updates + 1):
        state, metrics = train_step(state)
        if logger is not None and update % log_interval == 0:
            host = torch.stack([v.to(F32) for v in metrics.values()])
            logger.logkv("nupdates", update)
            logger.logkv("fps", int(update * nbatch * fpstep
                                    / (time.perf_counter() - t0)))
            for k, v in zip(metrics, host.tolist()):
                logger.logkv(k, v)
            logger.dumpkvs()
    if save_path is not None:
        ppo.save_params(save_path, state.module)
    return state

"""GAIL, generative adversarial imitation learning, with its expert
pipeline and behavior cloning (port of toybox_tpu.rl.gail).

The semantics are the JAX package's (the reference baselines/gail): a
discriminator D(s, a) learns to tell expert transitions from the
policy's, and the policy maximises the surrogate reward -log(1 - D) =
softplus(logit).

- ``generate_expert_dataset`` rolls a trained policy out on a batched env
  and records (obs, action) transitions, every ``stride``-th agent step,
  returned as host numpy arrays; ``save_expert_dataset`` and
  ``load_expert_dataset`` write and read them as npz files (keys ``obs``,
  ``acs``) that either package reads.
- ``behavior_clone`` fits the policy to the expert actions (Adam 3e-4,
  one permutation an epoch, wrapped at the tail so that every minibatch
  is full).
- ``make_gail_trpo``, the reference generator: TRPO steps
  (``trpo.trust_region_update``) on the current discriminator's reward,
  a separate value network, and a discriminator step every ``g_step``-th
  update (``learn`` paces it as the reference does).
- ``make_gail``, a PPO generator: the discriminator's steps first, then
  the reward from the updated discriminator and full-batch clipped
  surrogate steps.

Every update is a ``ppo.TrainStep``; its halves take their random draws
(the actions' Gumbel noise, the expert indices) from the state's
generator unless a caller hands them in, as the tests do with JAX's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
from torch import nn

from toybox_tpu_torch.envs.pipeline import FRAME_KERNEL_GAMES, make_rl_env
from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.distributions import (gumbel, gumbel_max,
                                               pd_from_logits)
from toybox_tpu_torch.rl.models import init_trunk
from toybox_tpu_torch.rl.policies import build_policy, noise_step
from toybox_tpu_torch.rl.trpo import (fit_value, trpo_batch,
                                      trust_region_update, value_net_step)

F32 = torch.float32
F = torch.nn.functional


def logit_bernoulli_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of Bernoulli(sigmoid(logits)) from the logits:
    (1 - sigmoid(l)) * l + softplus(-l)."""
    return (1.0 - torch.sigmoid(logits)) * logits + F.softplus(-logits)


class Discriminator(nn.Module):
    """(obs [N, ...], one-hot action [N, n_actions]) -> logit [N]: the obs
    flattened as stored (NHWC for frames), uint8 scaled by 1/255 and float
    taken as it is, the one-hot appended, then tanh(Dense hidden) twice
    and a Dense to one logit (> 0: "expert")."""

    def __init__(self, obs_shape, n_actions: int, hidden: int = 100):
        super().__init__()
        n_in = int(np.prod(obs_shape)) + n_actions
        self.layers = nn.ModuleList([nn.Linear(n_in, hidden),
                                     nn.Linear(hidden, hidden),
                                     nn.Linear(hidden, 1)])

    def forward(self, obs: torch.Tensor, onehot: torch.Tensor):
        o = obs.reshape(obs.shape[0], -1)
        x = o.to(F32) / 255.0 if o.dtype == torch.uint8 else o.to(F32)
        x = torch.cat([x, onehot.to(F32)], -1)
        x = torch.tanh(self.layers[0](x))
        x = torch.tanh(self.layers[1](x))
        return self.layers[2](x)[..., 0]


def make_discriminator(obs_shape, n_actions: int, seed: int, device):
    """A Discriminator initialised as flax initialises its Dense layers
    (lecun_normal kernels, zero biases) from ``seed``."""
    disc = Discriminator(obs_shape, n_actions)
    init_trunk(disc, torch.Generator().manual_seed(seed))
    return disc.to(device)


def disc_loss(disc, e_obs, e_onehot, p_obs, p_onehot, entcoeff: float):
    """(loss, accuracy): expert transitions labelled 1, the policy's 0,
    minus entcoeff times the mean Bernoulli entropy of all logits."""
    e_logit = disc(e_obs, e_onehot)
    p_logit = disc(p_obs, p_onehot)
    ent = logit_bernoulli_entropy(torch.cat([p_logit, e_logit])).mean()
    loss = (-F.logsigmoid(e_logit).mean() - F.logsigmoid(-p_logit).mean()
            - entcoeff * ent)
    acc = 0.5 * ((e_logit > 0).to(F32).mean() + (p_logit < 0).to(F32).mean())
    return loss, acc


def disc_steps_on(disc, adam: ppo.AdamState, expert_obs, expert_onehot,
                  fobs, pol_onehot, expert_idx, lr: float,
                  entcoeff: float) -> dict:
    """One Adam step (optax.adam(lr), eps 1e-8) of the discriminator for
    each row of ``expert_idx`` [steps, nbatch], in place; the last step's
    disc_loss and disc_acc (taken before it)."""
    params = list(disc.parameters())
    for idx in expert_idx:
        loss, acc = disc_loss(disc, expert_obs[idx], expert_onehot[idx],
                              fobs, pol_onehot, entcoeff)
        grads = torch.autograd.grad(loss, params)
        ppo.adam_update(params, grads, adam, lr, eps=1e-8)
    return dict(disc_loss=loss.detach(), disc_acc=acc)


def _expert_tensors(expert_obs, expert_actions, n_actions: int, dev):
    obs = torch.as_tensor(expert_obs, device=dev)
    onehot = F.one_hot(torch.as_tensor(expert_actions, device=dev).long(),
                       n_actions).to(F32)
    return obs, onehot


# ---------------------------------------------------------------------------
# The expert pipeline
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate_expert_dataset(env_fns, *, load_path=None, params=None,
                            n_transitions=4096, network="cnn", seed=0,
                            stochastic=True, stride=1, network_kwargs=None,
                            device="cuda", draws=None):
    """Roll a trained policy out on a batched env (tensors on ``device``)
    and record (obs, action) transitions: ceil(n_transitions / num_envs)
    recorded steps, each followed by stride - 1 unrecorded ones. The
    policy is ``params`` (a state_dict) or the file at ``load_path`` (a
    ``ppo.save_params`` file, e.g. a committed model). Actions are drawn
    from the logits, or their argmax unless ``stochastic``. Returns host
    numpy arrays (obs, int32 actions) cut to n_transitions; the device
    holds the recorded steps until one copy at the end.

    draws: ``seeds`` [num_envs] (the envs' reset seeds) and ``gumbel``
    [recorded steps * stride, num_envs, n_actions]; else both from a
    generator seeded with ``seed``."""
    dev = torch.device(device)
    module = build_policy(env_fns.obs_shape, env_fns.num_actions, network,
                          device=dev, **(network_kwargs or {}))[0]
    if params is None:
        if load_path is None:
            raise ValueError("need params or load_path")
        ppo.load_params(load_path, module)
    else:
        module.load_state_dict(params)
    num_envs = env_fns.num_envs
    nsteps = -(-n_transitions // num_envs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    seeds = (draws["seeds"] if draws is not None else torch.randint(
        0, 2**31 - 1, (num_envs,), generator=gen, device=dev))
    env_state, _ = env_fns.reset(seeds)
    obs0 = env_state.frames
    obs = torch.empty((nsteps,) + tuple(obs0.shape), dtype=obs0.dtype,
                      device=dev)
    actions = torch.empty((nsteps, num_envs), dtype=torch.int64, device=dev)
    for t in range(nsteps * stride):
        frames = env_state.frames
        logits = module(frames)[0]
        if stochastic:
            g = (draws["gumbel"][t] if draws is not None else
                 gumbel(logits.shape, gen, dev))
            acts = gumbel_max(logits, g)
        else:
            acts = logits.argmax(-1)
        if t % stride == 0:
            obs[t // stride] = frames
            actions[t // stride] = acts
        env_state, _, _, _, _ = env_fns.step(env_state, acts)
    obs = obs.reshape((-1,) + tuple(env_fns.obs_shape))[:n_transitions]
    actions = actions.reshape(-1)[:n_transitions].to(torch.int32)
    return obs.cpu().numpy(), actions.cpu().numpy()


def save_expert_dataset(path, obs, actions) -> None:
    """npz with the reference's expert-data keys (obs, acs)."""
    np.savez_compressed(path, obs=np.asarray(obs), acs=np.asarray(actions))


def load_expert_dataset(path):
    d = np.load(path)
    return d["obs"], d["acs"]


# ---------------------------------------------------------------------------
# Behavior cloning
# ---------------------------------------------------------------------------

def behavior_clone(env_fns, expert_obs, expert_actions, *, network="mlp",
                   epochs=50, batch_size=128, lr=3e-4, seed=0,
                   network_kwargs=None, device="cuda", draws=None):
    """Supervised pretraining: minimise the mean neglogp of the expert
    actions with Adam (lr, eps 1e-8), epochs x ceil(n / bs) minibatches
    of bs = min(batch_size, n), each epoch's permutation wrapped at the
    tail so that every minibatch is full. Returns (the policy module,
    initialised from ``seed`` as flax does, the last epoch's mean loss);
    the loss is read to the host once, at the end.

    draws: ``perms`` [epochs, n] and ``init``, the initial parameters (a
    state_dict); else the permutations from a generator seeded with
    ``seed``."""
    dev = torch.device(device)
    nact = env_fns.num_actions
    module, p_init, _, _ = build_policy(env_fns.obs_shape, nact, network,
                                        device=dev, **(network_kwargs or {}))
    p_init(seed)
    if draws is not None:
        module.load_state_dict(draws["init"])
    eobs = torch.as_tensor(expert_obs, device=dev)
    eacts = torch.as_tensor(expert_actions, device=dev).long()
    n = eobs.shape[0]
    bs = min(batch_size, n)
    steps = -(-n // bs)
    if draws is not None:
        perms = draws["perms"]
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        perms = [torch.randperm(n, generator=gen, device=dev)
                 for _ in range(epochs)]
    params = list(module.parameters())
    adam = ppo.AdamState.zeros_like(params)
    for perm in perms:
        idx = torch.cat([perm, perm[:steps * bs - n]]).reshape(steps, bs)
        losses = []
        for ids in idx:
            logits = module(eobs[ids])[0]
            loss = pd_from_logits(nact, logits).neglogp(eacts[ids]).mean()
            # the value head takes zero gradients, as in JAX
            grads = torch.autograd.grad(loss, params,
                                        materialize_grads=True)
            ppo.adam_update(params, grads, adam, lr, eps=1e-8)
            losses.append(loss.detach())
    return module, float(torch.stack(losses).mean())


# ---------------------------------------------------------------------------
# The PPO generator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GAILState:
    """The PPO-generator GAIL state; train_step updates it in place."""
    module: nn.Module            # the policy
    disc: nn.Module
    pi_adam: ppo.AdamState
    disc_adam: ppo.AdamState
    env_state: Any
    generator: torch.Generator   # actions and expert indices
    expert_obs: torch.Tensor
    expert_onehot: torch.Tensor
    update: int = 0


def make_gail(env_fns, expert_obs, expert_actions, *, network="mlp",
              nsteps=32, pi_lr=3e-3, disc_lr=1e-3, disc_steps=2,
              disc_entcoeff=1e-3, gamma=0.99, lam=0.95, cliprange=0.2,
              ent_coef=0.001, noptepochs=2, network_kwargs=None,
              device="cuda"):
    """Build (init_fn, train_step) of GAIL with a PPO generator over a
    batched env whose tensors lie on ``device``; the expert data goes to
    the device once.

    - init_fn(seed) -> GAILState: the policy from ``seed`` and the
      discriminator from ``seed + 1`` as flax initialises them, zero Adam
      moments, the envs reset with seeds from the state's generator;
    - train_step, a ppo.TrainStep: ``collect(state, draws=None)`` the
      rollout (draws: ``gumbel`` [nsteps, N, n_actions]) and the last
      value under the policy as it is; ``optimize(state, collected,
      draws=None)`` disc_steps discriminator steps (draws: ``expert_idx``
      [disc_steps, nbatch]), the reward softplus(logit) of the updated
      discriminator, GAE, and noptepochs full-batch Adam steps (pi_lr) on
      pg + 0.5 (0.5 mse) - ent_coef ent."""
    dev = torch.device(device)
    num_envs, nact = env_fns.num_envs, env_fns.num_actions
    nbatch = num_envs * nsteps
    module, p_init, _, _ = build_policy(
        env_fns.obs_shape, nact, network, device=dev,
        **(network_kwargs or {}))
    eobs, eonehot = _expert_tensors(expert_obs, expert_actions, nact, dev)
    storage = {}

    def init_fn(seed: int = 0) -> GAILState:
        p_init(seed)
        disc = make_discriminator(env_fns.obs_shape, nact, seed + 1, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = torch.randint(0, 2**31 - 1, (num_envs,), generator=gen,
                              device=dev)
        env_state, _ = env_fns.reset(seeds)
        return GAILState(
            module=module, disc=disc,
            pi_adam=ppo.AdamState.zeros_like(list(module.parameters())),
            disc_adam=ppo.AdamState.zeros_like(list(disc.parameters())),
            env_state=env_state, generator=gen, expert_obs=eobs,
            expert_onehot=eonehot)

    def collect(state: GAILState, draws: dict | None = None):
        if "buf" not in storage:
            storage["buf"] = ppo.Rollout.empty(nsteps, num_envs,
                                               state.env_state.frames)
        buf = storage["buf"]
        noise = iter(draws["gumbel"]) if draws is not None else None
        state.env_state = ppo.rollout(noise_step(module, noise), env_fns,
                                      state.env_state, state.generator, buf)
        with torch.no_grad():
            last_value = module(state.env_state.frames)[1]
        return buf, last_value

    def optimize(state: GAILState, collected, draws: dict | None = None):
        buf, last_value = collected
        fobs = buf.obs.reshape((nbatch,) + tuple(buf.obs.shape[2:]))
        facts = buf.actions.reshape(nbatch)
        pol_onehot = F.one_hot(facts, nact).to(F32)
        idx = (draws["expert_idx"] if draws is not None else torch.randint(
            0, state.expert_obs.shape[0], (disc_steps, nbatch),
            generator=state.generator, device=dev))
        metrics = disc_steps_on(state.disc, state.disc_adam,
                                state.expert_obs, state.expert_onehot, fobs,
                                pol_onehot, idx, disc_lr, disc_entcoeff)
        with torch.no_grad():
            adv_reward = F.softplus(state.disc(fobs, pol_onehot))
        advs = ppo.gae(buf.values, adv_reward.reshape(nsteps, num_envs),
                       buf.dones, last_value, gamma, lam)
        fret = (advs + buf.values).reshape(nbatch)
        fadv = ppo.normalize(advs.reshape(nbatch))
        fnlp = buf.neglogps.reshape(nbatch)
        params = list(state.module.parameters())
        for _ in range(noptepochs):
            logits, vpred = state.module(fobs)
            pd = pd_from_logits(nact, logits)
            ratio = torch.exp(fnlp - pd.neglogp(facts))
            pg = torch.maximum(-fadv * ratio, -fadv * torch.clamp(
                ratio, 1 - cliprange, 1 + cliprange)).mean()
            vf = 0.5 * torch.square(vpred - fret).mean()
            ent = pd.entropy().mean()
            loss = pg + 0.5 * vf - ent_coef * ent
            grads = torch.autograd.grad(loss, params)
            ppo.adam_update(params, grads, state.pi_adam, pi_lr, eps=1e-8)
        metrics.update(pg_loss=pg.detach(), entropy=ent.detach(),
                       adv_reward=adv_reward.mean())
        state.update += 1
        return state, metrics

    return init_fn, ppo.TrainStep(collect, optimize)


# ---------------------------------------------------------------------------
# The TRPO generator (the reference gail/trpo_mpi.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GAILTRPOState:
    """The TRPO-generator GAIL state; train_step updates it in place.
    ``disc_metrics`` are the last discriminator step's (none before the
    first)."""
    module: nn.Module            # the policy
    vf: nn.Module                # the value network (its V head)
    vf_adam: ppo.AdamState
    disc: nn.Module
    disc_adam: ppo.AdamState
    env_state: Any
    generator: torch.Generator   # actions and expert indices
    expert_obs: torch.Tensor
    expert_onehot: torch.Tensor
    disc_metrics: dict = dataclasses.field(default_factory=dict)
    update: int = 0


def make_gail_trpo(env_fns, expert_obs, expert_actions, *, network="mlp",
                   nsteps=32, gamma=0.99, lam=0.97, max_kl=0.01,
                   cg_iters=10, cg_damping=0.1, vf_stepsize=3e-4,
                   vf_iters=3, ent_coef=0.0, disc_lr=3e-4, disc_steps=1,
                   disc_entcoeff=1e-3, reward_scale=1.0,
                   pretrain_params=None, g_step=1, network_kwargs=None,
                   device="cuda"):
    """Build (init_fn, train_step) of GAIL with the TRPO generator over a
    batched env whose tensors lie on ``device``.
    ``reward_scale=0`` ablates the adversarial reward;
    ``pretrain_params`` (a state_dict, e.g. behavior_clone's) warm-starts
    the policy.

    - init_fn(seed) -> GAILTRPOState: the policy (``seed``), the value
      network (``seed + 1``) and the discriminator (``seed + 2``) as flax
      initialises them, zero Adam moments, the envs reset with seeds from
      the state's generator;
    - train_step, a ppo.TrainStep: ``collect(state, draws=None)`` the
      rollout (draws: ``gumbel`` [nsteps, N, n_actions]; values from the
      value network) and its ``trpo.trpo_batch`` (fobs, facts, fadv, fnlp,
      fret) whose reward is reward_scale * softplus(logit) of the
      discriminator as it is, GAE(lam); ``optimize(state, collected,
      draws=None)`` the trust-region step, vf_iters Adam steps of the
      value network, and, when the update count (from 1) is a multiple
      of ``g_step``, disc_steps Adam steps (disc_lr) of the discriminator
      on the batch and expert rows (draws: ``expert_idx`` [disc_steps,
      nbatch]). With g_step 1 an update is JAX's ``train_step``."""
    dev = torch.device(device)
    num_envs, nact = env_fns.num_envs, env_fns.num_actions
    nbatch = num_envs * nsteps
    kw = network_kwargs or {}
    module, pi_init, _, _ = build_policy(env_fns.obs_shape, nact, network,
                                         device=dev, **kw)
    vf, vf_init, _, vf_value = build_policy(env_fns.obs_shape, nact,
                                            network, device=dev, **kw)
    eobs, eonehot = _expert_tensors(expert_obs, expert_actions, nact, dev)
    storage = {}

    def init_fn(seed: int = 0) -> GAILTRPOState:
        pi_init(seed)
        if pretrain_params is not None:
            module.load_state_dict(pretrain_params)
        vf_init(seed + 1)
        disc = make_discriminator(env_fns.obs_shape, nact, seed + 2, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = torch.randint(0, 2**31 - 1, (num_envs,), generator=gen,
                              device=dev)
        env_state, _ = env_fns.reset(seeds)
        return GAILTRPOState(
            module=module, vf=vf,
            vf_adam=ppo.AdamState.zeros_like(list(vf.parameters())),
            disc=disc,
            disc_adam=ppo.AdamState.zeros_like(list(disc.parameters())),
            env_state=env_state, generator=gen, expert_obs=eobs,
            expert_onehot=eonehot)

    def collect(state: GAILTRPOState, draws: dict | None = None):
        if "buf" not in storage:
            storage["buf"] = ppo.Rollout.empty(nsteps, num_envs,
                                               state.env_state.frames)
        buf = storage["buf"]
        noise = iter(draws["gumbel"]) if draws is not None else None
        state.env_state = ppo.rollout(
            value_net_step(noise_step(module, noise), vf_value), env_fns,
            state.env_state, state.generator, buf)
        with torch.no_grad():
            adv_reward = reward_scale * F.softplus(state.disc(
                buf.obs.reshape((nbatch,) + tuple(buf.obs.shape[2:])),
                F.one_hot(buf.actions.reshape(nbatch), nact).to(F32)))
        batch = trpo_batch(buf, vf_value(state.env_state.frames), gamma, lam,
                           rewards=adv_reward.reshape(nsteps, num_envs))
        return batch, dict(adv_reward=adv_reward.mean(),
                           true_reward=buf.rewards.mean())

    def optimize(state: GAILTRPOState, collected,
                 draws: dict | None = None):
        (fobs, facts, fadv, fnlp, fret), roll_metrics = collected
        metrics, _ = trust_region_update(
            state.module, nact, fobs, facts, fadv, fnlp, max_kl=max_kl,
            cg_iters=cg_iters, cg_damping=cg_damping, ent_coef=ent_coef)
        vf_loss = fit_value(state.vf, state.vf_adam, fobs, fret, vf_iters,
                            vf_stepsize)
        state.update += 1
        if state.update % g_step == 0:
            idx = (draws["expert_idx"] if draws is not None else
                   torch.randint(0, state.expert_obs.shape[0],
                                 (disc_steps, nbatch),
                                 generator=state.generator, device=dev))
            state.disc_metrics = disc_steps_on(
                state.disc, state.disc_adam, state.expert_obs,
                state.expert_onehot, fobs, F.one_hot(facts, nact).to(F32),
                idx, disc_lr, disc_entcoeff)
        metrics.update(vf_loss=vf_loss, **roll_metrics,
                       **state.disc_metrics)
        return state, metrics

    return init_fn, ppo.TrainStep(collect, optimize)


# ---------------------------------------------------------------------------
# learn()
# ---------------------------------------------------------------------------

#: make_gail_trpo's knobs that learn() forwards when they are given
TRPO_KNOBS = ("gamma", "lam", "max_kl", "cg_iters", "cg_damping",
              "vf_stepsize", "vf_iters", "ent_coef", "disc_lr",
              "disc_steps", "disc_entcoeff", "reward_scale")


def learn(*, env=None, game="breakout", num_envs=8, expert_path=None,
          expert_model=None, n_expert_transitions=4096, expert_stride=1,
          total_updates=None, total_timesteps=None, seed=0,
          network="cnn_small", nsteps=32, bc_epochs=0, generator="trpo",
          g_step=3, log_interval=10, logger=None, save_path=None,
          load_path=None, network_kwargs=None, device="cuda", **extra):
    """The reference pipeline: the expert data (``expert_path``'s npz, or
    extracted from ``expert_model``, a NatureCNN policy file), an optional
    BC warm start (``bc_epochs``), then adversarial updates; saves the
    policy. ``load_path`` is the expert model when neither is given (the
    CLI's ``--alg=gail --load_path=models/<Game>.ppo1.model``), never a
    warm start. ``total_timesteps=0`` runs no adversarial update (BC
    only: the BC policy is saved as it is); neither count given means 100
    updates. The TRPO generator's discriminator steps every ``g_step``-th
    update; its knobs (``TRPO_KNOBS``) are forwarded when given. The env
    is built as ``ppo.learn`` builds it; TF32 is off; each logged update's
    metrics are read to the host at once."""
    kwargs = dict(network=network, nsteps=nsteps,
                  network_kwargs=network_kwargs, device=device)
    if generator == "trpo":
        kwargs.update({k: extra.pop(k) for k in TRPO_KNOBS if k in extra})
    elif generator != "ppo":
        raise ValueError(f"unknown generator {generator!r} (trpo or ppo)")
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    env_fns = env if env is not None else make_rl_env(
        game, num_envs, inkernel_warp=game in FRAME_KERNEL_GAMES,
        device=device)
    fpstep = getattr(env_fns, "frames_per_step", 1)
    if expert_model is None and expert_path is None:
        expert_model = load_path
    if total_updates is None:
        if total_timesteps is not None:
            total_updates = (0 if int(total_timesteps) == 0 else max(
                int(total_timesteps) // (env_fns.num_envs * nsteps * fpstep),
                1))
        else:
            total_updates = 100
    if expert_path is not None:
        expert_obs, expert_actions = load_expert_dataset(expert_path)
    else:
        if expert_model is None:
            raise ValueError("need expert_path or expert_model")
        expert_obs, expert_actions = generate_expert_dataset(
            env_fns, load_path=expert_model,
            n_transitions=n_expert_transitions, network="cnn", seed=seed,
            stride=expert_stride, device=device)
    expert_obs = torch.as_tensor(expert_obs, device=device)
    expert_actions = torch.as_tensor(expert_actions, device=device).long()

    pretrain = None
    if bc_epochs:
        bc, bc_loss = behavior_clone(
            env_fns, expert_obs, expert_actions, network=network,
            epochs=bc_epochs, seed=seed, network_kwargs=network_kwargs,
            device=device)
        pretrain = bc.state_dict()
        if logger is not None:
            logger.logkv("bc_final_loss", bc_loss)

    if generator == "trpo":
        init_fn, train_step = make_gail_trpo(
            env_fns, expert_obs, expert_actions, pretrain_params=pretrain,
            g_step=g_step, **kwargs)
        state = init_fn(seed)
    else:
        init_fn, train_step = make_gail(env_fns, expert_obs, expert_actions,
                                        **kwargs)
        state = init_fn(seed)
        if pretrain is not None:
            state.module.load_state_dict(pretrain)
    t0 = time.perf_counter()
    for i in range(1, total_updates + 1):
        state, metrics = train_step(state)
        if logger is not None and i % log_interval == 0:
            host = torch.stack([v.to(F32) for v in metrics.values()])
            logger.logkv("nupdates", i)
            logger.logkv("fps", int(i * env_fns.num_envs * nsteps * fpstep
                                    / (time.perf_counter() - t0)))
            for k, v in zip(metrics, host.tolist()):
                logger.logkv(k, v)
            logger.dumpkvs()
    if save_path is not None:
        ppo.save_params(save_path, state.module)
    return state

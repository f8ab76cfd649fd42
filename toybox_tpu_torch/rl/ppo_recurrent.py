"""Recurrent-policy PPO (port of toybox_tpu.rl.ppo_recurrent: the policy
``RecurrentPolicyWithValue``, ``make_recurrent_ppo`` and ``learn``) for
the lstm, cnn_lstm and cnn_lnlstm networks.

The scheme is the JAX package's (the reference ppo2's ``states`` and
``masks``): the LSTM carry rides the rollout, each step recording the
done flag of the step before it; the minibatches are blocks of ENVS, so
that each env's sequence stays whole, and the loss re-runs the policy over
all nsteps of its envs from the rollout's initial carry, the recorded
dones resetting the carry at episode boundaries. The convolutional trunk
runs once over a minibatch's [nsteps * envs] observations; only the LSTM
cell loops over time. Recurrent a2c (``rl.a2c``) shares the rollout and
the unrolled forward.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch
from torch import nn

from toybox_tpu_torch.envs.pipeline import FRAME_KERNEL_GAMES, make_rl_env
from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.distributions import CategoricalPd
from toybox_tpu_torch.rl.models import (RECURRENT_NETWORKS, init_trunk,
                                        network_factory)

F32 = torch.float32
METRICS = ("policy_loss", "value_loss", "policy_entropy")


class RecurrentPolicyWithValue(nn.Module):
    """(obs, carry, done) -> (logits [N, n_actions], value [N], new_carry)
    over a recurrent trunk (``rl.models.LSTMTrunk``)."""

    def __init__(self, trunk: nn.Module, n_actions: int):
        super().__init__()
        self.trunk = trunk
        self.pi = nn.Linear(trunk.latent, n_actions)
        self.vf = nn.Linear(trunk.latent, 1)

    def initial_carry(self, n: int):
        return self.trunk.initial_carry(n)

    def forward(self, obs: torch.Tensor, carry, done: torch.Tensor):
        latent, carry = self.trunk(obs, carry, done)
        return self.pi(latent), self.vf(latent)[..., 0], carry

    def unroll(self, obs: torch.Tensor, carry, dones: torch.Tensor):
        """forward over a time axis: obs [T, B, ...], dones [T, B] ->
        (logits [T, B, n_actions], values [T, B], last carry), equal to T
        forward calls threading the carry."""
        latents, carry = self.trunk.unroll(obs, carry, dones)
        return self.pi(latents), self.vf(latents)[..., 0], carry


def build_recurrent_policy(obs_shape, n_actions: int, network: str,
                           nlstm: int = 128, device="cuda",
                           network_kwargs=None):
    """(module, init_fn): the recurrent policy on ``device``; init_fn(seed)
    initialises it in place as flax initialises the JAX module (the trunk
    by ``init_trunk``, orthogonal heads of gain 0.01 for pi and 1 for V,
    zero biases), drawn from a CPU generator seeded with ``seed``."""
    if network not in RECURRENT_NETWORKS:
        raise ValueError(f"{network!r} is not recurrent; have "
                         f"{RECURRENT_NETWORKS}")

    def make():
        return RecurrentPolicyWithValue(network_factory(network)(
            tuple(obs_shape), nlstm=nlstm, **(network_kwargs or {})),
            n_actions)

    module = make().to(device)

    def init_fn(seed: int = 0) -> RecurrentPolicyWithValue:
        gen = torch.Generator().manual_seed(seed)
        cpu = make()
        init_trunk(cpu.trunk, gen)
        with torch.no_grad():
            nn.init.orthogonal_(cpu.pi.weight, 0.01, generator=gen)
            nn.init.zeros_(cpu.pi.bias)
            nn.init.orthogonal_(cpu.vf.weight, 1.0, generator=gen)
            nn.init.zeros_(cpu.vf.bias)
        module.load_state_dict(cpu.state_dict())
        return module

    return module, init_fn


# ---------------------------------------------------------------------------
# The recurrent rollout (shared with recurrent a2c)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecurrentRollout(ppo.Rollout):
    """A ppo.Rollout that also records each step's previous done flags."""
    prev_dones: torch.Tensor = None

    @classmethod
    def empty(cls, nsteps: int, num_envs: int, obs: torch.Tensor):
        buf = super().empty(nsteps, num_envs, obs)
        buf.prev_dones = torch.empty_like(buf.dones)
        return buf


@torch.no_grad()
def recurrent_rollout(module, env_fns, env_state, carry, prev_done,
                      generator: torch.Generator, buf: RecurrentRollout):
    """Fill ``buf`` with len(buf.obs) env steps under the recurrent policy,
    threading the carry; returns (env_state, carry, prev_done) after
    them."""
    for t in range(buf.obs.shape[0]):
        obs = env_state.frames
        buf.obs[t].copy_(obs)
        logits, values, carry = module(obs, carry, prev_done)
        pd = CategoricalPd(logits)
        actions = pd.sample(generator)
        env_state, _, rewards, dones, info = env_fns.step(env_state, actions)
        buf.actions[t] = actions
        buf.values[t] = values
        buf.neglogps[t] = pd.neglogp(actions)
        buf.rewards[t] = rewards
        buf.dones[t] = dones
        buf.prev_dones[t] = prev_done
        buf.ep_ret[t] = info["episode_return"]
        buf.ep_len[t] = info["episode_length"]
        prev_done = dones
    return env_state, carry, prev_done


# ---------------------------------------------------------------------------
# Loss and update
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecurrentBatch:
    """One rollout, time-major [nsteps, num_envs, ...], with the carry it
    started from (each [num_envs, nlstm])."""
    obs: torch.Tensor
    actions: torch.Tensor
    values: torch.Tensor
    neglogps: torch.Tensor
    returns: torch.Tensor
    advs: torch.Tensor
    prev_dones: torch.Tensor
    carry0: tuple


def minibatch_loss(module, rb: RecurrentBatch, idx: torch.Tensor,
                   clipr: float, ent_coef: float, vf_coef: float,
                   num_actions: int):
    """(loss, metrics) of the envs ``idx``: the policy re-run over all
    nsteps from their initial carry, then ppo.ppo_loss over the
    [nsteps, len(idx)] block (advantages normalised over the block)."""
    carry0 = tuple(c[idx] for c in rb.carry0)
    pdone = rb.prev_dones[:, idx]

    def forward(obs):
        logits, values, _ = module.unroll(obs, carry0, pdone)
        return logits, values

    mb = tuple(x[:, idx] for x in (rb.obs, rb.actions, rb.values,
                                   rb.neglogps, rb.returns, rb.advs))
    return ppo.ppo_loss(forward, mb, clipr, ent_coef, vf_coef, num_actions)


def update(module, adam: ppo.AdamState, rb: RecurrentBatch, perms: list,
           lrnow: float, cliprnow: float, hp: ppo.Hyper,
           num_actions: int) -> dict:
    """The minibatch epochs of one recurrent PPO update, in place on
    ``module`` and ``adam``: perms holds one permutation of the envs per
    epoch, each cut into hp.nminibatches blocks. Returns the mean of each
    metric over every minibatch (detached tensors)."""
    params = list(module.parameters())
    mb_envs = rb.obs.shape[1] // hp.nminibatches
    sums = {k: torch.zeros((), device=rb.values.device) for k in METRICS}
    for perm in perms:
        for i in range(hp.nminibatches):
            idx = perm[i * mb_envs:(i + 1) * mb_envs]
            loss, metrics = minibatch_loss(module, rb, idx, cliprnow,
                                           hp.ent_coef, hp.vf_coef,
                                           num_actions)
            grads = torch.autograd.grad(loss, params)
            grads = ppo.clip_by_global_norm(list(grads), hp.max_grad_norm)
            ppo.adam_update(params, grads, adam, lrnow)
            for k in METRICS:
                sums[k] += metrics[k].detach()
    n = len(perms) * hp.nminibatches
    return {k: v / n for k, v in sums.items()}


# ---------------------------------------------------------------------------
# make_recurrent_ppo
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecurrentPPOState:
    """The whole training state; train_step updates it in place."""
    module: RecurrentPolicyWithValue
    adam: ppo.AdamState
    env_state: Any
    carry: tuple                 # the live LSTM carry, each [N, nlstm]
    prev_done: torch.Tensor      # bool[N]: the episode ended at the last step
    generator: torch.Generator   # actions and epoch permutations
    update: int = 0


def make_recurrent_ppo(env_fns, *, network="cnn_lstm", nlstm=128,
                       lr=2.5e-4, cliprange=0.1, nsteps=128,
                       nminibatches=4, noptepochs=4, gamma=0.99, lam=0.95,
                       ent_coef=0.01, vf_coef=0.5, max_grad_norm=0.5,
                       total_updates=1, network_kwargs=None, device="cuda"):
    """Build (init_fn, train_step, module) over a batched env whose
    tensors lie on ``device``:

    - init_fn(seed) -> RecurrentPPOState: the policy initialised from
      ``seed``, zero Adam moments and carry, the envs reset with seeds
      drawn from the state's generator;
    - train_step(state) -> (state, metrics): an nsteps rollout threading
      the carry, GAE, then noptepochs x nminibatches Adam steps over
      blocks of num_envs / nminibatches envs; a ppo.TrainStep whose
      halves, ``collect`` and ``optimize``, can be timed apart."""
    num_envs = env_fns.num_envs
    if num_envs % nminibatches:
        raise ValueError(f"{num_envs} envs do not split into {nminibatches} "
                         "minibatches of envs")
    dev = torch.device(device)
    hp = ppo.Hyper(nminibatches=nminibatches, ent_coef=ent_coef,
                   vf_coef=vf_coef, max_grad_norm=max_grad_norm)
    module, p_init = build_recurrent_policy(
        env_fns.obs_shape, env_fns.num_actions, network, nlstm, dev,
        network_kwargs)
    storage = {}

    def init_fn(seed: int = 0) -> RecurrentPPOState:
        p_init(seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = torch.randint(0, 2**31 - 1, (num_envs,), generator=gen,
                              device=dev)
        env_state, _ = env_fns.reset(seeds)
        return RecurrentPPOState(
            module=module,
            adam=ppo.AdamState.zeros_like(list(module.parameters())),
            env_state=env_state, carry=module.initial_carry(num_envs),
            prev_done=torch.zeros(num_envs, dtype=torch.bool, device=dev),
            generator=gen)

    def collect(state: RecurrentPPOState):
        """The rollout half: nsteps env steps threading the carry, then
        GAE; returns (RecurrentBatch, rollout)."""
        if "buf" not in storage:
            storage["buf"] = RecurrentRollout.empty(
                nsteps, num_envs, state.env_state.frames)
        buf = storage["buf"]
        carry0 = state.carry
        state.env_state, state.carry, state.prev_done = recurrent_rollout(
            module, env_fns, state.env_state, state.carry, state.prev_done,
            state.generator, buf)
        with torch.no_grad():
            last_value = module(state.env_state.frames, state.carry,
                                state.prev_done)[1]
        advs = ppo.gae(buf.values, buf.rewards, buf.dones, last_value, gamma,
                       lam)
        return RecurrentBatch(
            obs=buf.obs, actions=buf.actions, values=buf.values,
            neglogps=buf.neglogps, returns=advs + buf.values, advs=advs,
            prev_dones=buf.prev_dones, carry0=carry0), buf

    def optimize(state: RecurrentPPOState, collected):
        """The epochs half: noptepochs permutations of the envs, the
        minibatch Adam steps and the update's metrics."""
        rb, buf = collected
        lrnow, cliprnow = ppo.anneal(state.update, total_updates, lr,
                                     cliprange)
        perms = [torch.randperm(num_envs, generator=state.generator,
                                device=dev) for _ in range(noptepochs)]
        metrics = update(module, state.adam, rb, perms, lrnow, cliprnow, hp,
                         env_fns.num_actions)
        ep = ppo.episode_metrics(buf)
        metrics.update(eprewmean=ep["eprewmean"],
                       mean_reward=ep["mean_reward"])
        state.update += 1
        return state, metrics

    return init_fn, ppo.TrainStep(collect, optimize), module


# ---------------------------------------------------------------------------
# learn()
# ---------------------------------------------------------------------------

def learn(*, env=None, game="breakout", num_envs=8, total_timesteps=10_000,
          seed=0, network="cnn_lstm", nlstm=128, nsteps=128, nminibatches=4,
          noptepochs=4, lr=2.5e-4, cliprange=0.1, gamma=0.99, lam=0.95,
          ent_coef=0.01, vf_coef=0.5, max_grad_norm=0.5, log_interval=1,
          save_path=None, load_path=None, logger=None, network_kwargs=None,
          device="cuda", **extra):
    """Train recurrent PPO for total_timesteps env frames; returns the
    RecurrentPPOState. The env is built as ``ppo.learn`` builds it (the
    in-kernel warp for a game with a frame kernel); TF32 is off."""
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    env_fns = env if env is not None else make_rl_env(
        game, num_envs, inkernel_warp=game in FRAME_KERNEL_GAMES,
        device=device)
    nbatch = env_fns.num_envs * nsteps
    fpstep = getattr(env_fns, "frames_per_step", 1)
    total_updates = max(int(total_timesteps) // (nbatch * fpstep), 1)

    init_fn, train_step, module = make_recurrent_ppo(
        env_fns, network=network, nlstm=nlstm, lr=lr, cliprange=cliprange,
        nsteps=nsteps, nminibatches=nminibatches, noptepochs=noptepochs,
        gamma=gamma, lam=lam, ent_coef=ent_coef, vf_coef=vf_coef,
        max_grad_norm=max_grad_norm, total_updates=total_updates,
        network_kwargs=network_kwargs, device=device)
    state = init_fn(seed)
    if load_path is not None:
        ppo.load_params(load_path, module)

    t0 = time.perf_counter()
    for update_count in range(1, total_updates + 1):
        state, metrics = train_step(state)
        if logger is not None and update_count % log_interval == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            logger.logkv("nupdates", update_count)
            logger.logkv("fps", int(update_count * nbatch * fpstep
                                    / (time.perf_counter() - t0)))
            for k, v in metrics.items():
                logger.logkv(k, v)
            logger.dumpkvs()
    if save_path is not None:
        ppo.save_params(save_path, module)
    return state

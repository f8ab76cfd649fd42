"""A2C, synchronous advantage actor-critic (port of toybox_tpu.rl.a2c:
``make_a2c``, ``make_recurrent_a2c`` and ``learn``).

The semantics are the JAX package's (the reference baselines a2c): an
nsteps rollout, n-step discounted returns bootstrapped from the value
head (no GAE), one gradient step a rollout on pg_loss - ent_coef * entropy
+ vf_coef * value_loss, with the reference defaults (lr 7e-4 annealed to
a floor of 1 %, nsteps 5, gamma .99, ent .01, vf .5, grad clip .5) and
optax.chain(clip_by_global_norm, scale_by_rms(decay .99, eps 1e-5),
scale(-1)) scaled by the lr after it (``ppo.rms_update``). The recurrent
form threads the LSTM carry through the rollout and re-runs the policy
over the time axis from the rollout's initial carry for its one step.

Each update is a ``ppo.TrainStep`` (``collect``, ``optimize``); ``learn``
runs blocks of ``updates_per_jit`` updates and reads their metrics to the
host once a block, as the JAX package scans a block per dispatch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from toybox_tpu_torch.envs.pipeline import FRAME_KERNEL_GAMES, make_rl_env
from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl import ppo
from toybox_tpu_torch.rl.distributions import pd_from_logits
from toybox_tpu_torch.rl.policies import RECURRENT_NETWORKS, build_policy
from toybox_tpu_torch.rl.ppo_recurrent import (RecurrentRollout,
                                               build_recurrent_policy,
                                               recurrent_rollout)
from toybox_tpu_torch.utils.checkpoint import Checkpointer

F32 = torch.float32
METRICS = ("policy_loss", "value_loss", "policy_entropy")


def discounted_returns(rewards: torch.Tensor, dones: torch.Tensor,
                       last_value: torch.Tensor,
                       gamma: float) -> torch.Tensor:
    """n-step returns [nsteps, N], a backward loop over time:
    ret_t = r_t + gamma * ret_{t+1} * (1 - done_t), from last_value."""
    returns = torch.empty_like(rewards)
    ret = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        ret = rewards[t] + gamma * ret * (1.0 - dones[t].to(F32))
        returns[t] = ret
    return returns


def a2c_loss(logits: torch.Tensor, vpred: torch.Tensor,
             actions: torch.Tensor, returns: torch.Tensor, ent_coef: float,
             vf_coef: float, num_actions, mean=None):
    """(loss, metrics) of the policy's outputs on a rollout, as the JAX
    ``loss_fn``: the advantage returns - vpred is held constant in the
    policy loss. ``mean`` takes the place of each per-row mean (a rank's
    share of a rollout spread over a mesh: its rows' sum over the whole
    rollout's size)."""
    if mean is None:
        def mean(x):
            return x.mean()
    pd = pd_from_logits(num_actions, logits)
    neglogp = pd.neglogp(actions)
    adv = returns - vpred
    pg_loss = mean(adv.detach() * neglogp)
    vf_loss = 0.5 * mean(torch.square(vpred - returns))
    entropy = mean(pd.entropy())
    loss = pg_loss - entropy * ent_coef + vf_loss * vf_coef
    return loss, dict(policy_loss=pg_loss, value_loss=vf_loss,
                      policy_entropy=entropy)


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The loss and optimizer settings of one make_a2c."""
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    alpha: float = 0.99
    epsilon: float = 1e-5


def step(module, rms: ppo.RmsState, loss: torch.Tensor, lrnow: float,
         hp: Hyper) -> None:
    """The one gradient step of an update, in place: clip the gradients
    of ``loss`` to hp.max_grad_norm, then ``ppo.rms_update``."""
    params = list(module.parameters())
    grads = ppo.clip_by_global_norm(list(torch.autograd.grad(loss, params)),
                                    hp.max_grad_norm)
    ppo.rms_update(params, grads, rms, lrnow, hp.alpha, hp.epsilon)


def update(module, rms: ppo.RmsState, obs: torch.Tensor,
           actions: torch.Tensor, returns: torch.Tensor, lrnow: float,
           hp: Hyper, num_actions) -> dict:
    """One feed-forward A2C step on a rollout (time-major [nsteps, N]
    obs, actions and returns), in place; returns the metrics."""
    logits, vpred = module(obs.reshape((-1,) + tuple(obs.shape[2:])))
    loss, metrics = a2c_loss(logits, vpred, actions.reshape(-1),
                             returns.reshape(-1), hp.ent_coef, hp.vf_coef,
                             num_actions)
    step(module, rms, loss, lrnow, hp)
    return {k: v.detach() for k, v in metrics.items()}


def recurrent_update(module, rms: ppo.RmsState, obs: torch.Tensor,
                     actions: torch.Tensor, returns: torch.Tensor,
                     prev_dones: torch.Tensor, carry0, lrnow: float,
                     hp: Hyper, num_actions) -> dict:
    """One recurrent A2C step: the policy re-run over the rollout's time
    axis from ``carry0`` with the recorded previous dones, in place;
    returns the metrics."""
    logits, vpred, _ = module.unroll(obs, carry0, prev_dones)
    loss, metrics = a2c_loss(logits, vpred, actions, returns, hp.ent_coef,
                             hp.vf_coef, num_actions)
    step(module, rms, loss, lrnow, hp)
    return {k: v.detach() for k, v in metrics.items()}


def _episode_metrics(buf) -> dict:
    ep = ppo.episode_metrics(buf)
    return {k: ep[k] for k in ("eprewmean", "episodes", "mean_reward")}


# ---------------------------------------------------------------------------
# make_a2c, make_recurrent_a2c
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class A2CState:
    """The whole training state; train_step updates it in place. The
    recurrent form also carries the LSTM carry and the last done flags."""
    module: torch.nn.Module
    rms: ppo.RmsState
    env_state: Any
    generator: torch.Generator   # the actions
    update: int = 0
    carry: tuple | None = None
    prev_done: torch.Tensor | None = None

    def state_dict(self) -> dict:
        return {"params": self.module.state_dict(), "nu": self.rms.nu,
                "env_state": self.env_state,
                "generator": self.generator.get_state(),
                "update": self.update, "carry": self.carry,
                "prev_done": self.prev_done}

    def load_state_dict(self, d: dict) -> None:
        dev = next(self.module.parameters()).device
        self.module.load_state_dict(d["params"])
        self.rms = ppo.RmsState(nu=[v.to(dev) for v in d["nu"]])
        self.env_state = d["env_state"]
        self.generator.set_state(d["generator"])
        self.update = int(d["update"])
        if d["carry"] is not None:
            self.carry = tuple(c.to(dev) for c in d["carry"])
            self.prev_done = d["prev_done"].to(dev)


#: the recurrent form keeps its carry in the same class
RecurrentA2CState = A2CState


def _init(module, p_init, env_fns, dev, recurrent: bool):
    def init_fn(seed: int = 0) -> A2CState:
        p_init(seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        n = env_fns.num_envs
        seeds = torch.randint(0, 2**31 - 1, (n,), generator=gen, device=dev)
        env_state, _ = env_fns.reset(seeds)
        st = A2CState(module=module,
                      rms=ppo.RmsState.zeros_like(list(module.parameters())),
                      env_state=env_state, generator=gen)
        if recurrent:
            st.carry = module.initial_carry(n)
            st.prev_done = torch.zeros(n, dtype=torch.bool, device=dev)
        return st
    return init_fn


def make_a2c(env_fns, *, network="cnn", lr=7e-4, nsteps=5, gamma=0.99,
             ent_coef=0.01, vf_coef=0.5, max_grad_norm=0.5, alpha=0.99,
             epsilon=1e-5, total_updates=1, network_kwargs=None,
             device="cuda"):
    """Build (init_fn, train_step) over a batched env whose tensors lie on
    ``device``: init_fn(seed) -> A2CState (the policy initialised as flax
    does, zero RMS moments, the envs reset from seeds drawn from the
    state's generator); train_step(state) -> (state, metrics), a
    ppo.TrainStep: ``collect`` is the rollout and the returns, ``optimize``
    the one RMSProp step."""
    dev = torch.device(device)
    hp = Hyper(ent_coef=ent_coef, vf_coef=vf_coef,
               max_grad_norm=max_grad_norm, alpha=alpha, epsilon=epsilon)
    module, p_init, p_step, p_value = build_policy(
        env_fns.obs_shape, env_fns.num_actions, network, device=dev,
        **(network_kwargs or {}))
    storage = {}

    def collect(state: A2CState):
        if "buf" not in storage:
            storage["buf"] = ppo.Rollout.empty(nsteps, env_fns.num_envs,
                                               state.env_state.frames)
        buf = storage["buf"]
        state.env_state = ppo.rollout(p_step, env_fns, state.env_state,
                                      state.generator, buf)
        returns = discounted_returns(buf.rewards, buf.dones,
                                     p_value(state.env_state.frames), gamma)
        return returns, buf

    def optimize(state: A2CState, collected):
        returns, buf = collected
        lrnow, _ = ppo.anneal(state.update, total_updates, lr, 0.0)
        metrics = update(module, state.rms, buf.obs, buf.actions, returns,
                         lrnow, hp, env_fns.num_actions)
        metrics.update(_episode_metrics(buf))
        state.update += 1
        return state, metrics

    return (_init(module, p_init, env_fns, dev, False),
            ppo.TrainStep(collect, optimize))


def make_recurrent_a2c(env_fns, *, network="cnn_lstm", nlstm=128, lr=7e-4,
                       nsteps=5, gamma=0.99, ent_coef=0.01, vf_coef=0.5,
                       max_grad_norm=0.5, alpha=0.99, epsilon=1e-5,
                       total_updates=1, network_kwargs=None, device="cuda"):
    """make_a2c with an lstm, cnn_lstm or cnn_lnlstm policy
    (``ppo_recurrent.RecurrentPolicyWithValue``): the carry rides the
    rollout, and the one step re-runs the policy over the time axis from
    the rollout's initial carry with the recorded previous dones."""
    dev = torch.device(device)
    hp = Hyper(ent_coef=ent_coef, vf_coef=vf_coef,
               max_grad_norm=max_grad_norm, alpha=alpha, epsilon=epsilon)
    module, p_init = build_recurrent_policy(
        env_fns.obs_shape, env_fns.num_actions, network, nlstm, dev,
        network_kwargs)
    storage = {}

    def collect(state: A2CState):
        if "buf" not in storage:
            storage["buf"] = RecurrentRollout.empty(
                nsteps, env_fns.num_envs, state.env_state.frames)
        buf = storage["buf"]
        carry0 = state.carry
        state.env_state, state.carry, state.prev_done = recurrent_rollout(
            module, env_fns, state.env_state, state.carry, state.prev_done,
            state.generator, buf)
        with torch.no_grad():
            last_value = module(state.env_state.frames, state.carry,
                                state.prev_done)[1]
        returns = discounted_returns(buf.rewards, buf.dones, last_value,
                                     gamma)
        return (returns, carry0), buf

    def optimize(state: A2CState, collected):
        (returns, carry0), buf = collected
        lrnow, _ = ppo.anneal(state.update, total_updates, lr, 0.0)
        metrics = recurrent_update(module, state.rms, buf.obs, buf.actions,
                                   returns, buf.prev_dones, carry0, lrnow,
                                   hp, env_fns.num_actions)
        metrics.update(_episode_metrics(buf))
        state.update += 1
        return state, metrics

    return (_init(module, p_init, env_fns, dev, True),
            ppo.TrainStep(collect, optimize))


# ---------------------------------------------------------------------------
# learn()
# ---------------------------------------------------------------------------

def run_blocks(train_step, state, *, total_updates: int,
               updates_per_jit: int, log_interval: int, logger,
               frames_per_update: int, checkpoint_path, checkpoint_freq,
               sums=("episodes",)):
    """The JAX a2c/acktr learn loop: restore the latest checkpoint, then
    run whole blocks of updates_per_jit updates (the block ends
    ``range(start + upj, total_updates + 1, upj)``). A block's metrics are
    its last update's, with eprewmean the nanmean over the block and each
    key of ``sums`` summed over it; they are read to the host at once,
    and logged when the block's index is a multiple of
    log_interval // upj. Checkpoints every checkpoint_freq updates."""
    ckpt = Checkpointer(checkpoint_path, checkpoint_freq)
    state = ckpt.restore(state)
    start, upj = state.update, max(int(updates_per_jit), 1)
    every = max(log_interval // upj, 1)
    t0 = time.perf_counter()
    for block_end in range(start + upj, total_updates + 1, upj):
        ms = []
        for _ in range(upj):
            state, m = train_step(state)
            ms.append(m)
        if logger is not None and (block_end // upj) % every == 0:
            metrics = dict(ms[-1])
            metrics["eprewmean"] = torch.nanmean(
                torch.stack([m["eprewmean"] for m in ms]))
            for k in sums:
                metrics[k] = torch.stack([m[k] for m in ms]).sum()
            host = torch.stack([v.to(F32) for v in metrics.values()])
            logger.logkv("nupdates", block_end)
            logger.logkv("total_timesteps", block_end * frames_per_update)
            logger.logkv("fps", int((block_end - start) * frames_per_update
                                    / (time.perf_counter() - t0)))
            for k, v in zip(metrics, host.tolist()):
                logger.logkv(k, v)
            logger.dumpkvs()
        ckpt.maybe_save(state, block_end)
    return state


def learn(*, env=None, game="breakout", num_envs=16, total_timesteps=10_000,
          seed=0, network="cnn", nsteps=5, gamma=0.99, ent_coef=0.01,
          vf_coef=0.5, lr=7e-4, max_grad_norm=0.5, log_interval=100,
          save_path=None, load_path=None, logger=None, network_kwargs=None,
          checkpoint_path=None, checkpoint_freq=500, updates_per_jit=1,
          nlstm=128, device="cuda", **extra):
    """Train A2C (recurrent for lstm, cnn_lstm, cnn_lnlstm) for
    total_timesteps env frames; returns the A2CState. The env is built as
    ``ppo.learn`` builds it; TF32 is off. Updates run in whole blocks of
    ``updates_per_jit`` (the JAX recipe: 64); a block is logged when its
    index is a multiple of log_interval // updates_per_jit."""
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    env_fns = env if env is not None else make_rl_env(
        game, num_envs, inkernel_warp=game in FRAME_KERNEL_GAMES,
        device=device)
    nbatch = env_fns.num_envs * nsteps
    fpstep = getattr(env_fns, "frames_per_step", 1)
    total_updates = max(int(total_timesteps) // (nbatch * fpstep), 1)

    recurrent = network in RECURRENT_NETWORKS
    maker = make_recurrent_a2c if recurrent else make_a2c
    init_fn, train_step = maker(
        env_fns, network=network, lr=lr, nsteps=nsteps, gamma=gamma,
        ent_coef=ent_coef, vf_coef=vf_coef, max_grad_norm=max_grad_norm,
        total_updates=total_updates, network_kwargs=network_kwargs,
        device=device, **({"nlstm": nlstm} if recurrent else {}))
    state = init_fn(seed)
    if load_path is not None:
        ppo.load_params(load_path, state.module)

    state = run_blocks(
        train_step, state, total_updates=total_updates,
        updates_per_jit=updates_per_jit, log_interval=log_interval,
        logger=logger, frames_per_update=nbatch * fpstep,
        checkpoint_path=checkpoint_path, checkpoint_freq=checkpoint_freq)
    if save_path is not None:
        ppo.save_params(save_path, state.module)
    return state


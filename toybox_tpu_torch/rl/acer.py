"""ACER, actor-critic with experience replay (port of toybox_tpu.rl.acer:
``RecurrentQPolicy``, the trajectory replay, ``_acer_losses``,
``make_acer``, ``make_recurrent_acer`` and ``learn``).

The semantics are the JAX package's (the reference baselines acer): a
policy with a Q head, a ring of whole nsteps trajectories, Retrace(1)
targets, truncated importance sampling with bias correction (c = 10), an
entropy bonus, and the trust-region update that projects the policy
head's gradient on the logits against a Polyak-averaged policy (delta 1,
alpha .99). The optimizer is optax.chain(clip_by_global_norm(10),
scale_by_rms(.99, 1e-5), scale(-lr)) written out (``ppo.rms_update``).

A cycle is a ``ppo.TrainStep``: ``collect`` is the on-policy rollout,
written straight into the ring's next slot; ``optimize`` takes one SGD
step on it, then ``replay_ratio`` steps on trajectories drawn from the
ring once it holds more than one, every step against the cycle's starting
average policy, then moves the average. The recurrent form stores each
step's episode-start flags and re-runs the policy over a trajectory from
the zero carry, as the reference replays recurrent trajectories. The
ring's cursor and size are host integers, so a cycle reads nothing back
from the device; its draws come from the state's generator or from
``draws`` handed in.
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
from toybox_tpu_torch.rl.distributions import gumbel, gumbel_max
from toybox_tpu_torch.rl.models import (RECURRENT_NETWORKS, init_trunk,
                                        lecun_normal_, network_factory)
from toybox_tpu_torch.rl.policies import PolicyWithValue

F32 = torch.float32
METRICS = ("pg_loss", "q_loss", "entropy", "mean_rho")


class RecurrentQPolicy(nn.Module):
    """(obs, carry, done) -> (logits [N, n_actions], Q [N, n_actions],
    new_carry) over a recurrent trunk (``rl.models.LSTMTrunk``)."""

    def __init__(self, trunk: nn.Module, n_actions: int):
        super().__init__()
        self.trunk = trunk
        self.pi = nn.Linear(trunk.latent, n_actions)
        self.vf = nn.Linear(trunk.latent, n_actions)

    def initial_carry(self, n: int):
        return self.trunk.initial_carry(n)

    def forward(self, obs: torch.Tensor, carry, done: torch.Tensor):
        latent, carry = self.trunk(obs, carry, done)
        return self.pi(latent), self.vf(latent), carry

    def unroll(self, obs: torch.Tensor, carry, dones: torch.Tensor):
        """forward over a time axis: obs [T, B, ...], dones [T, B] ->
        (logits, Q [T, B, n_actions], last carry)."""
        latents, carry = self.trunk.unroll(obs, carry, dones)
        return self.pi(latents), self.vf(latents), carry


def build_acer_policy(obs_shape, n_actions: int, network: str,
                      nlstm: int = 128, device="cuda", network_kwargs=None):
    """(module, init_fn): PolicyWithValue with a Q head, or for a
    recurrent network RecurrentQPolicy, on ``device``. init_fn(seed)
    initialises it in place as flax initialises the JAX module, drawn from
    a CPU generator seeded with ``seed``: the trunk by ``init_trunk``, pi
    orthogonal (gain 0.01), the Q head orthogonal (gain 1) in the
    recurrent policy and lecun_normal in the feed-forward one, zero
    biases."""
    recurrent = network in RECURRENT_NETWORKS
    kw = dict(network_kwargs or {}, **({"nlstm": nlstm} if recurrent
                                       else {}))

    def make():
        trunk = network_factory(network)(tuple(obs_shape), **kw)
        if recurrent:
            return RecurrentQPolicy(trunk, n_actions)
        return PolicyWithValue(trunk, n_actions, estimate_q=True)

    module = make().to(device)

    def init_fn(seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        cpu = make()
        init_trunk(cpu.trunk, gen)
        with torch.no_grad():
            nn.init.orthogonal_(cpu.pi.weight, 0.01, generator=gen)
            if recurrent:
                nn.init.orthogonal_(cpu.vf.weight, 1.0, generator=gen)
            else:
                lecun_normal_(cpu.vf.weight, cpu.vf.weight.shape[1], gen)
            nn.init.zeros_(cpu.pi.bias)
            nn.init.zeros_(cpu.vf.bias)
        module.load_state_dict(cpu.state_dict())
        return module

    return module, init_fn


# ---------------------------------------------------------------------------
# The losses
# ---------------------------------------------------------------------------

def retrace(rewards, dones, q_a, v, rho_a, v_last, gamma: float):
    """Retrace(1) targets [T, N], a backward loop over time from v_last:
    qret_t = r_t + gamma * next * (1 - done_t), then
    next = min(1, rho_t) * (qret_t - q_t) + v_t."""
    qret = torch.empty_like(rewards)
    nonterm = 1.0 - dones.to(F32)
    c = torch.clamp(rho_a, max=1.0)
    nxt = v_last
    for t in range(rewards.shape[0] - 1, -1, -1):
        qret[t] = rewards[t] + gamma * nxt * nonterm[t]
        nxt = c[t] * (qret[t] - q_a[t]) + v[t]
    return qret


def acer_losses(pi, logits, q, pi_avg, actions, rewards, mus, dones, *,
                gamma: float, c: float, delta: float, ent_coef: float,
                q_coef: float, trust_region: bool):
    """(loss, metrics) of network outputs over a trajectory ([T+1, N,
    nact], the last step the bootstrap) and its actions, rewards,
    behaviour probabilities ``mus`` and dones [T, N(, nact)], as JAX's
    ``_acer_losses``. The advantages, ratios and Retrace targets are
    constants. With ``trust_region`` the policy gradient on the logits,
    g, is taken on a detached copy, projected against k = pi - pi_avg,
    and reaches the trunk through sum(g' * logits) / (T * N); the Q loss
    0.5 * (qret - Q_a)^2 reaches it through Q."""
    T, n = actions.shape
    nact = pi.shape[-1]
    pi_t, q_t, logits_t = pi[:-1], q[:-1], logits[:-1]
    onehot = torch.nn.functional.one_hot(actions.long(), nact).to(F32)
    q_a = (q_t * onehot).sum(-1)
    pi_a = (pi_t * onehot).sum(-1)
    with torch.no_grad():
        pid, qd = pi.detach(), q.detach()
        v = (pid[:-1] * qd[:-1]).sum(-1)
        v_last = (pid[-1] * qd[-1]).sum(-1)
        mu_a = (mus * onehot).sum(-1) + 1e-8
        rho = pid[:-1] / (mus + 1e-8)
        rho_a = (pid[:-1] * onehot).sum(-1) / mu_a
        qret = retrace(rewards, dones, q_a.detach(), v, rho_a, v_last,
                       gamma)
        adv = qret - v
        coef_f = adv * torch.clamp(rho_a, max=c)
        coef_bc = (qd[:-1] - v[..., None]) * torch.clamp(
            1.0 - c / (rho + 1e-8), min=0.0) * pid[:-1]
    entropy = -(pi_t * torch.log(pi_t + 1e-8)).sum(-1)

    if trust_region:
        lg = logits_t.detach().requires_grad_(True)
        with torch.enable_grad():
            p = torch.softmax(lg, -1)
            lf = torch.log((p * onehot).sum(-1) + 1e-8) * coef_f
            lbc = (torch.log(p + 1e-8) * coef_bc).sum(-1)
            ent = -(p * torch.log(p + 1e-8)).sum(-1)
            g, = torch.autograd.grad(-(lf + lbc + ent_coef * ent).mean(),
                                     lg)
        k = (pi_t - pi_avg[:-1]).detach()
        kg = (k * g).sum(-1, keepdim=True)
        k2 = (k * k).sum(-1, keepdim=True)
        g_proj = g - torch.clamp((kg - delta) / (k2 + 1e-8), min=0.0) * k
        pg_loss = (g_proj * logits_t).sum() / (T * n)
    else:
        gain_f = torch.log(pi_a + 1e-8) * coef_f
        gain_bc = (torch.log(pi_t + 1e-8) * coef_bc).sum(-1)
        pg_loss = -(gain_f + gain_bc + ent_coef * entropy).mean()

    q_loss = 0.5 * torch.square(qret - q_a).mean()
    loss = pg_loss + q_coef * q_loss
    return loss, dict(pg_loss=pg_loss.detach(), q_loss=q_loss.detach(),
                      entropy=entropy.detach().mean(), mean_rho=rho_a.mean())


# ---------------------------------------------------------------------------
# The trajectory ring and the SGD step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrajReplay:
    """A ring of whole trajectories on the device, time-major inside each
    slot; ``masks`` (the recurrent form) flags each step's episode
    start. cursor and size are host integers."""
    obs: torch.Tensor          # [cap, T+1, N, ...]
    actions: torch.Tensor      # int64[cap, T, N]
    rewards: torch.Tensor      # f32[cap, T, N]
    mus: torch.Tensor          # f32[cap, T, N, nact] behaviour probs
    dones: torch.Tensor        # bool[cap, T, N]
    masks: torch.Tensor | None = None   # bool[cap, T+1, N]
    cursor: int = 0
    size: int = 0

    @classmethod
    def empty(cls, cap: int, nsteps: int, num_envs: int, obs_shape,
              obs_dtype, nact: int, recurrent: bool, device):
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        tn = (cap, nsteps, num_envs)
        return cls(obs=z((cap, nsteps + 1, num_envs) + tuple(obs_shape),
                         obs_dtype),
                   actions=z(tn, torch.int64), rewards=z(tn, F32),
                   mus=z(tn + (nact,), F32), dones=z(tn, torch.bool),
                   masks=(z((cap, nsteps + 1, num_envs), torch.bool)
                          if recurrent else None))

    def slot(self, i) -> tuple:
        """Trajectory ``i`` (an int or an int64 device scalar, read with
        index_select: no sync) as (obs, actions, rewards, mus, dones,
        masks)."""
        if torch.is_tensor(i):
            return tuple(None if x is None else
                         x.index_select(0, i.view(1))[0]
                         for x in (self.obs, self.actions, self.rewards,
                                   self.mus, self.dones, self.masks))
        return tuple(None if x is None else x[i]
                     for x in (self.obs, self.actions, self.rewards,
                               self.mus, self.dones, self.masks))

    def state_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The loss and optimizer settings of one make_acer."""
    lr: float = 7e-4
    gamma: float = 0.99
    q_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 10.0
    c: float = 10.0
    trust_region: bool = True
    delta: float = 1.0
    alpha: float = 0.99
    rprop_alpha: float = 0.99
    rprop_epsilon: float = 1e-5


def _outputs(module, obs_seq, masks):
    """(pi, logits, Q) [T+1, N, nact] of a trajectory: the feed-forward
    policy over all its observations at once, the recurrent one unrolled
    from the zero carry with the episode-start masks."""
    steps, n = obs_seq.shape[:2]
    if masks is None:
        logits, q = module(obs_seq.reshape((-1,) + tuple(obs_seq.shape[2:])))
        logits = logits.reshape(steps, n, -1)
        q = q.reshape(steps, n, -1)
    else:
        logits, q, _ = module.unroll(obs_seq, module.initial_carry(n), masks)
    return torch.softmax(logits, -1), logits, q


def sgd_step(module, avg, rms: ppo.RmsState, batch: tuple,
             hp: Hyper) -> dict:
    """One RMSProp step on a trajectory (``TrajReplay.slot``'s tuple), in
    place on ``module`` and ``rms``; ``avg`` (the average policy) is read
    only. Returns the loss metrics."""
    obs_seq, actions, rewards, mus, dones, masks = batch
    pi, logits, q = _outputs(module, obs_seq, masks)
    with torch.no_grad():
        pi_avg = _outputs(avg, obs_seq, masks)[0]
    loss, metrics = acer_losses(
        pi, logits, q, pi_avg, actions, rewards, mus, dones, gamma=hp.gamma,
        c=hp.c, delta=hp.delta, ent_coef=hp.ent_coef, q_coef=hp.q_coef,
        trust_region=hp.trust_region)
    params = list(module.parameters())
    grads = ppo.clip_by_global_norm(list(torch.autograd.grad(loss, params)),
                                    hp.max_grad_norm)
    ppo.rms_update(params, grads, rms, hp.lr, hp.rprop_alpha,
                   hp.rprop_epsilon)
    return metrics


@torch.no_grad()
def polyak(avg: nn.Module, module: nn.Module, alpha: float) -> None:
    """avg := alpha * avg + (1 - alpha) * module, parameter by parameter."""
    for a, p in zip(avg.parameters(), module.parameters()):
        a.copy_(alpha * a + (1 - alpha) * p)


# ---------------------------------------------------------------------------
# make_acer, make_recurrent_acer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ACERState:
    """The whole training state; a cycle updates it in place. The
    recurrent form also carries the live LSTM carry and the last done
    flags."""
    module: nn.Module
    avg: nn.Module                 # the Polyak-averaged policy
    rms: ppo.RmsState
    env_state: Any
    replay: TrajReplay
    generator: torch.Generator     # actions and replay indices
    update: int = 0
    carry: tuple | None = None
    prev_done: torch.Tensor | None = None

    def state_dict(self) -> dict:
        return {"params": self.module.state_dict(),
                "avg": self.avg.state_dict(), "nu": self.rms.nu,
                "env_state": self.env_state,
                "replay": self.replay.state_dict(),
                "generator": self.generator.get_state(),
                "update": self.update, "carry": self.carry,
                "prev_done": self.prev_done}

    def load_state_dict(self, d: dict) -> None:
        dev = next(self.module.parameters()).device
        self.module.load_state_dict(d["params"])
        self.avg.load_state_dict(d["avg"])
        self.rms = ppo.RmsState(nu=[v.to(dev) for v in d["nu"]])
        self.env_state = d["env_state"]
        self.replay = TrajReplay(**{k: v.to(dev) if torch.is_tensor(v)
                                    else v for k, v in d["replay"].items()})
        self.generator.set_state(d["generator"])
        self.update = int(d["update"])
        if d["carry"] is not None:
            self.carry = tuple(c.to(dev) for c in d["carry"])
            self.prev_done = d["prev_done"].to(dev)


def make_acer(env_fns, *, network="cnn_small", nsteps=20, lr=7e-4,
              gamma=0.99, q_coef=0.5, ent_coef=0.01, max_grad_norm=10.0,
              c=10.0, trust_region=True, delta=1.0, alpha=0.99,
              replay_ratio=4, buffer_traj=50, rprop_alpha=0.99,
              rprop_epsilon=1e-5, network_kwargs=None, nlstm=128,
              device="cuda"):
    """Build (init_fn, cycle) over a batched env whose tensors lie on
    ``device``; a recurrent ``network`` (lstm, cnn_lstm, cnn_lnlstm) makes
    the recurrent form, which ``make_recurrent_acer`` names.

    - init_fn(seed) -> ACERState: the policy initialised as flax does, the
      average a copy, zero RMS moments, an empty ring of ``buffer_traj``
      trajectories, the envs reset with seeds drawn from the generator;
    - cycle(state) -> (state, metrics), a ppo.TrainStep:
      ``collect(state, draws=None)`` the nsteps rollout into the ring
      (draws: ``gumbel`` [nsteps, N, nact], the noise of the actions'
      Gumbel-max over log(pi + 1e-8)), returning the slot and the
      episode metrics; ``optimize(state, collected, draws=None)`` the SGD
      steps and the average (draws: ``replay_idx`` [replay_ratio] int64
      below max(size, 1))."""
    dev = torch.device(device)
    num_envs, nact = env_fns.num_envs, env_fns.num_actions
    obs_shape = tuple(env_fns.obs_shape)
    recurrent = network in RECURRENT_NETWORKS
    hp = Hyper(lr=lr, gamma=gamma, q_coef=q_coef, ent_coef=ent_coef,
               max_grad_norm=max_grad_norm, c=c, trust_region=trust_region,
               delta=delta, alpha=alpha, rprop_alpha=rprop_alpha,
               rprop_epsilon=rprop_epsilon)
    module, p_init = build_acer_policy(obs_shape, nact, network, nlstm, dev,
                                       network_kwargs)
    avg, _ = build_acer_policy(obs_shape, nact, network, nlstm, dev,
                               network_kwargs)

    def init_fn(seed: int = 0) -> ACERState:
        p_init(seed)
        avg.load_state_dict(module.state_dict())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = torch.randint(0, 2**31 - 1, (num_envs,), generator=gen,
                              device=dev)
        env_state, obs = env_fns.reset(seeds)
        st = ACERState(
            module=module, avg=avg,
            rms=ppo.RmsState.zeros_like(list(module.parameters())),
            env_state=env_state,
            replay=TrajReplay.empty(buffer_traj, nsteps, num_envs, obs_shape,
                                    obs.dtype, nact, recurrent, dev),
            generator=gen)
        if recurrent:
            st.carry = module.initial_carry(num_envs)
            st.prev_done = torch.zeros(num_envs, dtype=torch.bool,
                                       device=dev)
        return st

    @torch.no_grad()
    def collect(state: ACERState, draws: dict | None = None):
        rb, module = state.replay, state.module
        if draws is None:
            draws = {"gumbel": gumbel((nsteps, num_envs, nact),
                                      state.generator, dev)}
        cur = rb.cursor
        ep_ret = torch.empty((nsteps, num_envs), dtype=F32, device=dev)
        for t in range(nsteps):
            obs = state.env_state.frames
            rb.obs[cur, t] = obs
            if recurrent:
                logits, _, state.carry = module(obs, state.carry,
                                                state.prev_done)
                rb.masks[cur, t] = state.prev_done
            else:
                logits, _ = module(obs)
            pi = torch.softmax(logits, -1)
            actions = gumbel_max(torch.log(pi + 1e-8), draws["gumbel"][t])
            state.env_state, _, rewards, dones, info = env_fns.step(
                state.env_state, actions)
            rb.actions[cur, t] = actions
            rb.rewards[cur, t] = rewards
            rb.mus[cur, t] = pi
            rb.dones[cur, t] = dones
            ep_ret[t] = info["episode_return"]
            if recurrent:
                state.prev_done = dones
        rb.obs[cur, nsteps] = state.env_state.frames
        if recurrent:
            rb.masks[cur, nsteps] = rb.dones[cur, nsteps - 1]
        rb.cursor = (cur + 1) % rb.obs.shape[0]
        rb.size = min(rb.size + 1, rb.obs.shape[0])
        done = ~torch.isnan(ep_ret)
        n = done.to(F32).sum()
        ret = torch.where(done, ep_ret, torch.zeros_like(ep_ret)).sum()
        return cur, dict(
            eprewmean=torch.where(n > 0, ret / n, torch.full_like(n, float(
                "nan"))), mean_reward=rb.rewards[cur].mean())

    def optimize(state: ACERState, collected, draws: dict | None = None):
        rb = state.replay
        cur, ep_metrics = collected
        if draws is None:
            draws = {"replay_idx": torch.randint(
                0, max(rb.size, 1), (replay_ratio,),
                generator=state.generator, device=dev)}
        module, avg = state.module, state.avg
        metrics = sgd_step(module, avg, state.rms, rb.slot(cur), hp)
        if rb.size > 1:
            # each step against the cycle's starting average policy
            for i in range(replay_ratio):
                sgd_step(module, avg, state.rms,
                         rb.slot(draws["replay_idx"][i]), hp)
        polyak(avg, module, alpha)
        metrics.update(ep_metrics)
        state.update += 1
        return state, metrics

    return init_fn, ppo.TrainStep(collect, optimize)


#: the recurrent form keeps its carry and masks in the same classes
RecurrentACERState = ACERState
RecurrentTrajReplay = TrajReplay


def make_recurrent_acer(env_fns, *, network="cnn_lstm", **kwargs):
    """``make_acer`` over a recurrent ``network`` (lstm, cnn_lstm,
    cnn_lnlstm): (init_fn, cycle), the state a RecurrentACERState."""
    if network not in RECURRENT_NETWORKS:
        raise ValueError(f"{network!r} is not recurrent; have "
                         f"{RECURRENT_NETWORKS}")
    return make_acer(env_fns, network=network, **kwargs)


# ---------------------------------------------------------------------------
# learn()
# ---------------------------------------------------------------------------

def learn(*, env=None, game="breakout", num_envs=16, total_timesteps=100_000,
          seed=0, network="cnn_small", nsteps=20, lr=7e-4, gamma=0.99,
          q_coef=0.5, ent_coef=0.01, c=10.0, trust_region=True, delta=1.0,
          alpha=0.99, replay_ratio=4, buffer_traj=50, log_interval=20,
          save_path=None, load_path=None, logger=None, network_kwargs=None,
          cycles_per_jit=1, nlstm=128, device="cuda", **extra):
    """Train ACER (recurrent for lstm, cnn_lstm, cnn_lnlstm) for
    total_timesteps env frames; returns the ACERState. The env is built as
    ``ppo.learn`` builds it; TF32 is off. Cycles run in blocks of
    ``cycles_per_jit`` (the JAX recipe: 16); a block's metrics are its
    last cycle's with eprewmean the nanmean over the block, read to the
    host at once and logged when the block's index is a multiple of
    log_interval // cycles_per_jit."""
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    env_fns = env if env is not None else make_rl_env(
        game, num_envs, inkernel_warp=game in FRAME_KERNEL_GAMES,
        device=device)
    init_fn, cycle = make_acer(
        env_fns, network=network, nsteps=nsteps, lr=lr, gamma=gamma,
        q_coef=q_coef, ent_coef=ent_coef, c=c, trust_region=trust_region,
        delta=delta, alpha=alpha, replay_ratio=replay_ratio,
        buffer_traj=buffer_traj, network_kwargs=network_kwargs, nlstm=nlstm,
        device=device)
    state = init_fn(seed)
    if load_path is not None:
        ppo.load_params(load_path, state.module)

    upj = max(int(cycles_per_jit), 1)
    fpstep = getattr(env_fns, "frames_per_step", 1)
    frames = env_fns.num_envs * nsteps * fpstep * upj
    nblocks = max(int(total_timesteps) // frames, 1)
    every = max(log_interval // upj, 1)
    t0 = time.perf_counter()
    for i in range(1, nblocks + 1):
        ms = []
        for _ in range(upj):
            state, m = cycle(state)
            ms.append(m)
        if logger is not None and i % every == 0:
            metrics = dict(ms[-1])
            metrics["eprewmean"] = torch.nanmean(
                torch.stack([m["eprewmean"] for m in ms]))
            host = torch.stack([v.to(F32) for v in metrics.values()])
            logger.logkv("nupdates", i * upj)
            logger.logkv("fps", int(i * frames / (time.perf_counter() - t0)))
            for k, v in zip(metrics, host.tolist()):
                logger.logkv(k, v)
            logger.dumpkvs()
    if save_path is not None:
        ppo.save_params(save_path, state.module)
    return state

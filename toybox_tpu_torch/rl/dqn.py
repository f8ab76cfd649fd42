"""DQN, deep Q-learning with a device-resident prioritized replay (port of
toybox_tpu.rl.dqn: ``QNetwork``, the replay ring, ``make_dqn`` and
``learn``).

The semantics are the JAX package's (the reference baselines deepq):
double-Q targets from a target network synced every
``target_network_update_freq`` env steps, a Huber loss weighted by the
prioritized replay's importance weights, new priorities |td| + 1e-6, and
optax.chain(clip_by_global_norm(10), adam(lr, eps=1e-4)) written out
(``ppo.adam_update``). Exploration is epsilon-greedy, epsilon annealed
over ``exploration_fraction`` of training, or, with ``param_noise``,
greedy on a copy of the network whose weights carry Gaussian noise, its
scale walked toward the epsilon-matched KL threshold.

The replay is a fixed-capacity ring of device tensors. Prioritized
sampling is a Gumbel-max draw over alpha * log(priority), masked to the
filled region: proportional sampling with replacement, as in JAX.

A cycle is a ``ppo.TrainStep``: ``collect`` takes train_freq env steps,
each inserted into the ring; ``optimize`` samples a batch, takes one Adam
step once ``learning_starts`` env steps have passed (before that the Adam
state and the priorities stay as they are, as JAX masks them), syncs the
target on schedule and adapts the noise scale. The env step count ``t``,
the ring's cursor and its size are host integers: they depend on the
cycle count alone, so a cycle reads nothing back from the device. Every
random draw comes from the state's generator, or from ``draws`` that a
caller (a test replaying JAX's draws) hands in.
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
from toybox_tpu_torch.rl.distributions import gumbel
from toybox_tpu_torch.rl.models import init_trunk, network_factory
from toybox_tpu_torch.utils.checkpoint import Checkpointer

F32 = torch.float32
METRICS = ("loss", "epsilon", "mean_q")


class QNetwork(nn.Module):
    """obs -> Q [N, n_actions]: a trunk, then an advantage stream (Dense
    ``hiddens`` with relu, Dense n_actions). With ``dueling`` (the
    default, and every committed checkpoint) also a state value stream
    (Dense ``hiddens`` with relu, Dense 1), combined as V + A - mean(A);
    without it the advantage stream's scores are Q."""

    def __init__(self, trunk: nn.Module, n_actions: int, hiddens: int = 256,
                 dueling: bool = True):
        super().__init__()
        self.trunk = trunk
        self.adv_hidden = nn.Linear(trunk.latent, hiddens)
        self.adv_out = nn.Linear(hiddens, n_actions)
        self.dueling = dueling
        if dueling:
            self.val_hidden = nn.Linear(trunk.latent, hiddens)
            self.val_out = nn.Linear(hiddens, 1)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        latent = self.trunk(obs)
        scores = self.adv_out(torch.relu(self.adv_hidden(latent)))
        if not self.dueling:
            return scores
        value = self.val_out(torch.relu(self.val_hidden(latent)))
        return value + (scores - scores.mean(-1, keepdim=True))


def epsilon_greedy(q: torch.Tensor, eps: float,
                   generator: torch.Generator) -> torch.Tensor:
    """argmax Q, replaced by a uniform random action with probability
    ``eps`` (the random action drawn first, then the coin)."""
    greedy = q.argmax(-1)
    rand = torch.randint(0, q.shape[-1], greedy.shape, generator=generator,
                         device=q.device)
    explore = torch.rand(greedy.shape, generator=generator,
                         device=q.device) < eps
    return torch.where(explore, rand, greedy)


# ---------------------------------------------------------------------------
# The replay ring
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Replay:
    """A ring of transitions on the device; cursor and size on the host."""
    obs: torch.Tensor          # [cap, ...] (u8 frames)
    next_obs: torch.Tensor     # [cap, ...]
    actions: torch.Tensor      # int64[cap]
    rewards: torch.Tensor      # f32[cap]
    dones: torch.Tensor        # bool[cap]
    priorities: torch.Tensor   # f32[cap]
    cursor: int = 0
    size: int = 0

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    def state_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def make_replay(capacity: int, obs_shape, obs_dtype=torch.uint8,
                device="cuda") -> Replay:
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    shape = (capacity,) + tuple(obs_shape)
    return Replay(obs=z(shape, obs_dtype), next_obs=z(shape, obs_dtype),
                  actions=z(capacity, torch.int64), rewards=z(capacity, F32),
                  dones=z(capacity, torch.bool), priorities=z(capacity, F32))


def replay_add(rb: Replay, obs, next_obs, actions, rewards, dones,
               slots=None) -> None:
    """Insert a batch of transitions at the cursor, in place; each new
    entry's priority is max(max priority, 1).

    ``slots`` (a ``parallel.mesh.Block``) shards the ring on its capacity
    axis over a mesh: ``rb`` holds this rank's slots, the cursor and the
    size are the whole ring's (host ints, alike on every rank), and the
    batch is this rank's env rows. Every rank's rows are gathered in rank
    order (the one-process env order) and each lands on the rank that
    holds its slot. Without ``slots`` the ring is one process's."""
    from toybox_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce,
                                                env_block)
    if slots is None:
        slots = env_block(None, rb.capacity)
    mesh = slots.mesh
    obs, next_obs, actions, rewards, dones = (
        all_gather_rows(x, mesh) for x in (obs, next_obs, actions.long(),
                                           rewards.to(F32), dones))
    n = obs.shape[0]
    max_p = torch.clamp(all_reduce(rb.priorities.max(), mesh, "max"),
                        min=1.0)
    for j0, j1, l0 in slots.runs(rb.cursor, n):
        sl = slice(l0, l0 + j1 - j0)
        rb.obs[sl] = obs[j0:j1].to(rb.obs.dtype)
        rb.next_obs[sl] = next_obs[j0:j1].to(rb.obs.dtype)
        rb.actions[sl] = actions[j0:j1]
        rb.rewards[sl] = rewards[j0:j1]
        rb.dones[sl] = dones[j0:j1]
        rb.priorities[sl] = max_p
    rb.cursor = (rb.cursor + n) % slots.n_global
    rb.size = min(rb.size + n, slots.n_global)


def replay_sample(rb: Replay, noise: torch.Tensor, alpha: float,
                  beta: float, slots=None):
    """(batch, idx, weights): ``noise`` [batch, cap] standard Gumbel
    noise picks each row as argmax(alpha * log p + noise) over the filled
    region (proportional to p ** alpha, with replacement); the importance
    weights (size * P(i)) ** -beta are divided by their max. batch is
    (obs, actions, rewards, next_obs, dones).

    Over a ring sharded by ``slots`` (``replay_add``) ``noise`` is the
    whole ring's draw, alike on every rank. Each rank takes the argmax
    over its own slots; a gather of every rank's winners picks the global
    one (the first rank on a tie, as one argmax takes the first slot),
    and its owner supplies the row. The log-normaliser of the priorities
    is reduced over every slot. The result is the same on every rank."""
    from toybox_tpu_torch.parallel.mesh import (all_gather_rows, all_reduce,
                                                env_block)
    if slots is None:
        slots = env_block(None, rb.capacity)
    mesh, lo = slots.mesh, slots.lo
    dev = noise.device
    valid = lo + torch.arange(slots.n_local, device=dev) < rb.size
    logits = alpha * torch.log(torch.clamp(rb.priorities, min=1e-8))
    logits = torch.where(valid, logits, torch.full_like(logits,
                                                        -float("inf")))
    scores = logits[None, :] + slots.take(noise, 1)
    best = torch.argmax(scores, dim=-1)
    won = scores.gather(1, best[:, None])[:, 0]
    owner = torch.argmax(all_gather_rows(won[None], mesh), dim=0)
    idx = all_gather_rows((best + lo)[None], mesh).gather(
        0, owner[None])[0]
    lse_local = torch.logsumexp(logits, 0)
    m = all_reduce(lse_local, mesh, "max")
    lse = m + torch.log(all_reduce(torch.exp(lse_local - m), mesh))
    mine = owner == mesh.rank
    rows = torch.where(mine, idx - lo, torch.zeros_like(idx))

    def supply(x):
        picked = x[rows]
        keep = mine.view((-1,) + (1,) * (picked.dim() - 1))
        return all_reduce(torch.where(keep, picked,
                                      torch.zeros_like(picked)), mesh)

    p = torch.exp(supply(logits) - lse)
    w = (float(max(rb.size, 1)) * torch.clamp(p, min=1e-12)) ** -beta
    w = w / w.max()
    batch = (supply(rb.obs), supply(rb.actions), supply(rb.rewards),
             supply(rb.next_obs), supply(rb.dones))
    return batch, idx, w


# ---------------------------------------------------------------------------
# make_dqn
# ---------------------------------------------------------------------------

@torch.no_grad()
def perturb(dst: nn.Module, src: nn.Module, noise: dict,
            scale: torch.Tensor) -> nn.Module:
    """dst's parameters := src's + scale * noise[name], every weight and
    bias (the reference's perturbable variables); returns dst."""
    for (name, p), q in zip(src.named_parameters(), dst.parameters()):
        q.copy_(p + scale * noise[name])
    return dst


def normal_noise(module: nn.Module, generator: torch.Generator) -> dict:
    """A standard normal draw of every parameter's shape, by name."""
    return {n: torch.randn(p.shape, generator=generator, device=p.device)
            for n, p in module.named_parameters()}


@dataclasses.dataclass
class DQNState:
    """The whole training state; a cycle updates it in place."""
    module: QNetwork               # the online network (its parameters)
    target: QNetwork
    adam: ppo.AdamState
    env_state: Any
    replay: Replay
    generator: torch.Generator     # every draw of the cycle
    pn_scale: torch.Tensor         # f32 adaptive parameter-noise stddev
    t: int = 0                     # env steps so far (agent steps x envs)
    update: int = 0                # cycles so far

    def state_dict(self) -> dict:
        return {"params": self.module.state_dict(),
                "target": self.target.state_dict(), "mu": self.adam.mu,
                "nu": self.adam.nu, "count": self.adam.count,
                "env_state": self.env_state,
                "replay": self.replay.state_dict(),
                "generator": self.generator.get_state(),
                "pn_scale": self.pn_scale, "t": self.t,
                "update": self.update}

    def load_state_dict(self, d: dict) -> None:
        dev = self.pn_scale.device
        self.module.load_state_dict(d["params"])
        self.target.load_state_dict(d["target"])
        self.adam = ppo.AdamState(mu=[v.to(dev) for v in d["mu"]],
                                  nu=[v.to(dev) for v in d["nu"]],
                                  count=int(d["count"]))
        self.env_state = d["env_state"]
        self.replay = Replay(**{k: v.to(dev) if torch.is_tensor(v) else v
                                for k, v in d["replay"].items()})
        self.generator.set_state(d["generator"])
        self.pn_scale = d["pn_scale"].to(dev)
        self.t, self.update = int(d["t"]), int(d["update"])


def make_dqn(env_fns, *, network="conv_only", lr=1e-4, gamma=0.99,
             buffer_size=10000, batch_size=32, train_freq=4,
             learning_starts=1000, target_network_update_freq=1000,
             exploration_fraction=0.1, exploration_final_eps=0.01,
             total_timesteps=100_000, prioritized_replay=True,
             prioritized_replay_alpha=0.6, prioritized_replay_beta0=0.4,
             dueling=True, double_q=True, grad_norm_clipping=10.0,
             param_noise=False, param_noise_scale0=0.01,
             network_kwargs=None, device="cuda", mesh=None):
    """Build (init_fn, cycle, module) over a batched env whose tensors lie
    on ``device``:

    - init_fn(seed) -> DQNState: the Q network initialised as flax does
      (lecun_normal kernels, zero biases) from ``seed``, the target a
      copy, zero Adam moments, an empty ring, the envs reset with seeds
      drawn from the state's generator;
    - cycle(state) -> (state, metrics), a ppo.TrainStep:
      ``collect(state, draws=None)`` the train_freq env steps and inserts
      (draws: ``act_noise``, the acting copy's weight noise by parameter
      name, with param_noise, else ``explore_u`` [train_freq, N] uniform
      and ``rand_actions`` [train_freq, N]), returning the env step count
      before them; ``optimize(state, t_before, draws=None)`` the rest
      (draws: ``gumbel`` [batch_size, buffer_size] and, with param_noise,
      ``adapt_noise``);
    - module: the online QNetwork.

    With a ``mesh`` (``parallel.mesh.make_mesh``) ``env_fns`` holds this
    rank's block of the mesh's envs (built with ``seed_stride`` = all of
    them) and the ring is sharded on its capacity axis, ``buffer_size`` /
    ranks slots a rank (``replay_add``, ``replay_sample``). Every draw is
    made for the whole env set and ring, alike on every rank, and each
    rank takes its block; the sampled batch is the same on every rank, so
    the learning step runs replicated. A cycle is then the single ring's
    cycle: the same sampled slots, the params up to the order of sums."""
    from toybox_tpu_torch.parallel.mesh import env_block
    dev = torch.device(device)
    num_envs, nact = env_fns.num_envs, env_fns.num_actions
    envs = env_block(mesh, num_envs)
    n_all, ranks = envs.n_global, envs.mesh.size
    if buffer_size % ranks:
        raise ValueError(f"a ring of {buffer_size} does not split over "
                         f"{ranks} ranks")
    slots = env_block(mesh, buffer_size // ranks)
    obs_shape = tuple(env_fns.obs_shape)
    kw = network_kwargs or {}

    def make():
        return QNetwork(network_factory(network)(obs_shape, **kw), nact,
                        dueling=dueling)

    module, target = make().to(dev), make().to(dev)
    noisy = make().to(dev) if param_noise else None
    f32 = np.float32
    expl_steps = max(int(exploration_fraction * total_timesteps), 1)
    alpha = prioritized_replay_alpha if prioritized_replay else 0.0

    # the schedules in f32 as JAX computes them (the python constants'
    # arithmetic in double, then rounded once)
    def epsilon(t: int) -> float:
        frac = min(f32(t) / f32(expl_steps), f32(1.0))
        return float(f32(1.0) + frac * f32(exploration_final_eps - 1.0))

    def beta(t: int) -> float:
        frac = min(f32(t) / f32(max(total_timesteps, 1)), f32(1.0))
        return float(f32(prioritized_replay_beta0)
                     + frac * f32(1.0 - prioritized_replay_beta0))

    def init_fn(seed: int = 0) -> DQNState:
        cpu = make()
        init_trunk(cpu, torch.Generator().manual_seed(seed))
        module.load_state_dict(cpu.state_dict())
        target.load_state_dict(cpu.state_dict())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = envs.take(torch.randint(0, 2**31 - 1, (n_all,),
                                        generator=gen, device=dev))
        env_state, _ = env_fns.reset(seeds)
        return DQNState(
            module=module, target=target,
            adam=ppo.AdamState.zeros_like(list(module.parameters())),
            env_state=env_state,
            replay=make_replay(slots.n_local, obs_shape,
                               env_state.frames.dtype, dev),
            generator=gen,
            pn_scale=torch.full((), param_noise_scale0, dtype=F32,
                                device=dev))

    @torch.no_grad()
    def collect(state: DQNState, draws: dict | None = None) -> int:
        gen, net = state.generator, state.module
        if draws is None:
            draws = ({"act_noise": normal_noise(net, gen)} if param_noise
                     else {"explore_u": torch.rand(
                         (train_freq, n_all), generator=gen, device=dev),
                         "rand_actions": torch.randint(
                             0, nact, (train_freq, n_all), generator=gen,
                             device=dev)})
            if not param_noise:
                draws = {k: envs.take(v, 1) for k, v in draws.items()}
        eps = epsilon(state.t)
        if param_noise:
            net = perturb(noisy, net, draws["act_noise"], state.pn_scale)
        for i in range(train_freq):
            obs = state.env_state.frames
            actions = net(obs).argmax(-1)
            if not param_noise:
                actions = torch.where(draws["explore_u"][i] < eps,
                                      draws["rand_actions"][i], actions)
            state.env_state, _, rewards, dones, _ = env_fns.step(
                state.env_state, actions)
            replay_add(state.replay, obs, state.env_state.frames, actions,
                       rewards, dones, slots)
        t_before = state.t
        state.t += train_freq * n_all
        return t_before

    def optimize(state: DQNState, t_before: int, draws: dict | None = None):
        t, rb, gen = state.t, state.replay, state.generator
        module, target = state.module, state.target
        dev = state.pn_scale.device
        if draws is None:
            draws = {"gumbel": gumbel((batch_size, buffer_size), gen, dev)}
            if param_noise:
                draws["adapt_noise"] = normal_noise(module, gen)
        (bobs, bact, brew, bnext, bdone), idx, w = replay_sample(
            rb, draws["gumbel"], alpha, beta(t), slots)
        q_sel = module(bobs).gather(1, bact[:, None])[:, 0]
        with torch.no_grad():
            q_next_t = target(bnext)
            best = (module(bnext) if double_q else q_next_t).argmax(-1)
            q_next = q_next_t.gather(1, best[:, None])[:, 0]
            tgt = brew + gamma * (1.0 - bdone.to(F32)) * q_next
        td = q_sel - tgt
        huber = torch.where(td.abs() < 1.0, 0.5 * td * td, td.abs() - 0.5)
        loss = (w * huber).mean()
        td = td.detach()
        if t >= learning_starts:     # JAX masks the step before warm-up
            params = list(module.parameters())
            grads = ppo.clip_by_global_norm(
                list(torch.autograd.grad(loss, params)), grad_norm_clipping)
            ppo.adam_update(params, grads, state.adam, lr, eps=1e-4)
            if prioritized_replay:
                # sampled with replacement: a slot drawn twice is written
                # twice, both times with the same transition's |td|
                slots.scatter(rb.priorities, idx, td.abs() + 1e-6)
        if t // target_network_update_freq != \
                t_before // target_network_update_freq:
            target.load_state_dict(module.state_dict())
        eps = epsilon(t_before)
        metrics = dict(loss=loss.detach(),
                       epsilon=torch.full((), eps, dtype=F32, device=dev),
                       mean_q=td.abs().mean())
        if param_noise:
            with torch.no_grad():
                ad = perturb(noisy, module, draws["adapt_noise"],
                             state.pn_scale)
                logp = torch.log_softmax(module(bobs), -1)
                logq = torch.log_softmax(ad(bobs), -1)
                kl = (logp.exp() * (logp - logq)).sum(-1).mean()
                e = f32(eps)
                threshold = float(-np.log(f32(1.0) - e + e / f32(nact)))
                state.pn_scale = torch.where(kl > threshold,
                                             state.pn_scale / 1.01,
                                             state.pn_scale * 1.01)
            metrics["param_noise_scale"] = state.pn_scale
        state.update += 1
        return state, metrics

    return init_fn, ppo.TrainStep(collect, optimize), module


# ---------------------------------------------------------------------------
# learn()
# ---------------------------------------------------------------------------

def learn(*, env=None, game="breakout", num_envs=4, total_timesteps=100_000,
          seed=0, network="conv_only", lr=1e-4, buffer_size=10000,
          exploration_fraction=0.1, exploration_final_eps=0.01,
          train_freq=4, batch_size=32, learning_starts=1000,
          target_network_update_freq=1000, gamma=0.99,
          prioritized_replay=True, dueling=True, double_q=True,
          param_noise=False, log_interval=500, save_path=None,
          load_path=None, logger=None, network_kwargs=None,
          checkpoint_path=None, checkpoint_freq=50, jit_cycles=16,
          device="cuda", **extra):
    """Train DQN for total_timesteps env frames; returns the DQNState.
    The env is built as ``ppo.learn`` builds it; TF32 is off. Cycles run
    in blocks of ``jit_cycles`` (the JAX recipe: 128); a block's metrics
    are its last cycle's, read to the host at once and logged every
    ``log_interval`` blocks. The checkpointer restores the latest state
    (the ring with it) and resumes at the block its env step count
    reaches; it saves every ``checkpoint_freq`` blocks."""
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    full_f32()
    env_fns = env if env is not None else make_rl_env(
        game, num_envs, inkernel_warp=game in FRAME_KERNEL_GAMES,
        device=device)
    init_fn, cycle, module = make_dqn(
        env_fns, network=network, lr=lr, gamma=gamma,
        buffer_size=buffer_size, batch_size=batch_size,
        train_freq=train_freq, learning_starts=learning_starts,
        target_network_update_freq=target_network_update_freq,
        exploration_fraction=exploration_fraction,
        exploration_final_eps=exploration_final_eps,
        total_timesteps=total_timesteps,
        prioritized_replay=prioritized_replay, dueling=dueling,
        double_q=double_q, param_noise=param_noise,
        network_kwargs=network_kwargs, device=device)
    state = init_fn(seed)
    if load_path is not None:
        ppo.load_params(load_path, module)

    jit_cycles = max(int(jit_cycles), 1)
    ckpt = Checkpointer(checkpoint_path, checkpoint_freq)
    state = ckpt.restore(state)
    start = state.t // (train_freq * env_fns.num_envs * jit_cycles)
    fpstep = getattr(env_fns, "frames_per_step", 1)
    frames_per_block = train_freq * env_fns.num_envs * fpstep * jit_cycles
    nblocks = max(int(total_timesteps) // frames_per_block, 1)
    t0 = time.perf_counter()
    for i in range(start + 1, nblocks + 1):
        for _ in range(jit_cycles):
            state, metrics = cycle(state)
        if logger is not None and i % log_interval == 0:
            host = torch.stack([v.to(F32) for v in metrics.values()])
            logger.logkv("steps", i * frames_per_block)
            logger.logkv("fps", int((i - start) * frames_per_block
                                    / (time.perf_counter() - t0)))
            for k, v in zip(metrics, host.tolist()):
                logger.logkv(k, v)
            logger.dumpkvs()
        ckpt.maybe_save(state, i)
    if save_path is not None:
        ppo.save_params(save_path, module)
    return state


# ---------------------------------------------------------------------------
# Multi-rank dry run (the port's parallel.dryrun.dryrun_multichip)
# ---------------------------------------------------------------------------

def dryrun(n_devices: int, game: str = "breakout", device="cuda",
           sharded: bool = True):
    """One full DQN cycle on tiny shapes (2 envs a rank, a ring of 16
    slots a rank, cnn_small, batch 8, train_freq 2, learning from the
    start, prioritized, dueling, double Q), the ring sharded on its
    capacity axis over a mesh of the process group's ``n_devices`` ranks
    (``sharded``), or the same cycle in one process without a mesh. The
    env is built as the JAX dryrun builds it (``make_rl_env`` at 84).
    Returns (state, metrics)."""
    from toybox_tpu_torch.parallel.dryrun import dryrun_mesh
    full_f32()
    mesh = dryrun_mesh(n_devices, sharded)
    ranks = mesh.size if sharded else 1
    env_fns = make_rl_env(game, 2 * n_devices // ranks, frame_size=84,
                          seed_stride=2 * n_devices, device=device)
    init_fn, cycle, _ = make_dqn(
        env_fns, network="cnn_small", buffer_size=16 * n_devices,
        batch_size=8, train_freq=2, learning_starts=0, total_timesteps=64,
        prioritized_replay=True, dueling=True, double_q=True,
        device=device, mesh=mesh)
    return cycle(init_fn(0))

"""ACKTR, actor-critic with a Kronecker-factored trust region (port of
toybox_tpu.rl.acktr: ``KfacCNNPolicy``, ``make_acktr`` and ``learn``).

A2C's n-step advantage loss (``rl.a2c``), its gradients preconditioned by
K-FAC (``rl.kfac``) and the step scaled into a KL trust region, in the
JAX train_step's order: the raw gradients and the layers' taps from one
backward pass; the per-batch factors; their EMA (decay .99) with the bias
correction 1 - .99^(update+1); the damped inverses, refreshed when
update % invert_every == 0 and kept in the state between; the
preconditioned gradients; vFv = sum(precond * raw) over the parameters;
coeff = min(lrnow, sqrt(kfac_clip / max(vFv, 1e-12))); then the gradients
clipped to a global norm of .5, optax sgd(1.0, momentum .9), and the step
scaled by coeff. The lr (0.25) anneals to a floor of 5 %.

The taps are the JAX package's: flax's ``init`` leaves the ``kfac``
collection holding each layer's input on the init's zero observation
(batch 1), and ``apply`` appends the batch's input after it, so the
factors read ``a[0]``, the init's input; the ``perturbations`` variables
have the init's batch of 1, so their gradient is the pre-activation
gradient summed over the batch. The state keeps the init's inputs
(``kfac_a``) and each update takes the gradient of a [1, ...] zero
perturbation; ``save_params`` writes both collections as flax does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from toybox_tpu_torch.envs.pipeline import FRAME_KERNEL_GAMES, make_rl_env
from toybox_tpu_torch.regress import full_f32
from toybox_tpu_torch.rl import a2c, ppo
from toybox_tpu_torch.rl.checkpoint import (load_flax_tree, params_from_flax,
                                            params_to_flax, save_flax_tree)
from toybox_tpu_torch.rl.distributions import CategoricalPd, gumbel
from toybox_tpu_torch.rl.kfac import (KfacConv, KfacDense, kfac_apply,
                                      kfac_factors, kfac_inverse_shapes,
                                      kfac_invert)
from toybox_tpu_torch.rl.models import (NATURE_CONVS, _conv_out, _norm_obs,
                                        init_trunk)

F32 = torch.float32
METRICS = ("policy_loss", "value_loss", "policy_entropy", "step_coeff")


class KfacCNNPolicy(nn.Module):
    """obs -> (logits [N, n_actions], value [N]). Image obs (``obs_shape``
    (h, w, c), uint8 NHWC): NatureCNN's convolutions ``conv0..2`` and a
    Dense ``fc0`` of ``hidden`` units, all with relu; vector obs
    (``obs_shape`` (dim,)): ``fc0`` alone. Then the heads ``pi`` and
    ``vf``. ``forward`` takes each layer's perturbation (``perts``) and
    records each layer's input into ``record``, for K-FAC."""

    def __init__(self, n_actions: int, obs_shape=(84, 84, 4),
                 convs=NATURE_CONVS, hidden: int = 512):
        super().__init__()
        self.image = len(obs_shape) == 3
        self.convs = tuple(convs) if self.image else ()
        if self.image:
            h, w, c = obs_shape
            for i, (ch, k, s) in enumerate(self.convs):
                setattr(self, f"conv{i}", KfacConv(c, ch, k, s))
                h, w, c = _conv_out(h, k, s), _conv_out(w, k, s), ch
            self.conv_out = (c, h, w)
            flat = c * h * w
        else:
            flat = obs_shape[0]
        self.fc0 = KfacDense(flat, hidden)
        self.pi = KfacDense(hidden, n_actions)
        self.vf = KfacDense(hidden, 1)

    def layer_meta(self) -> dict:
        """{layer: ("conv", kernel, stride) | ("dense",)}, input first."""
        meta = {f"conv{i}": ("conv", k, s)
                for i, (_, k, s) in enumerate(self.convs)}
        meta.update(fc0=("dense",), pi=("dense",), vf=("dense",))
        return meta

    def forward(self, obs: torch.Tensor, perts: dict | None = None,
                record: dict | None = None):
        def layer(name, x):
            if record is not None:
                record[name] = x
            return getattr(self, name)(x, None if perts is None
                                       else perts[name])

        if self.image:
            x = _norm_obs(obs.permute(0, 3, 1, 2))
            for i in range(len(self.convs)):
                x = torch.relu(layer(f"conv{i}", x))
            x = x.flatten(1)
        else:
            x = _norm_obs(obs)
        x = torch.relu(layer("fc0", x))
        return layer("pi", x), layer("vf", x)[..., 0]


# ---------------------------------------------------------------------------
# The taps in the flax layout (NHWC, and fc0's input flattened as (h, w, c))
# ---------------------------------------------------------------------------

def _tap_to_flax(net: KfacCNNPolicy, name: str, x: torch.Tensor):
    """A layer's input (``kfac_a``) in the flax layout."""
    x = x.detach().cpu()
    if x.ndim == 4:
        x = x.permute(0, 2, 3, 1)
    elif name == "fc0" and net.image:
        x = x.reshape((x.shape[0],) + net.conv_out).permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], -1)
    return np.ascontiguousarray(x.numpy().astype(np.float32))


def _tap_from_flax(net: KfacCNNPolicy, name: str, x: np.ndarray,
                   device) -> torch.Tensor:
    """A layer's input in the flax layout -> the port's."""
    t = torch.from_numpy(np.array(x, np.float32))
    if t.ndim == 4:
        t = t.permute(0, 3, 1, 2)
    elif name == "fc0" and net.image:
        c, h, w = net.conv_out
        t = t.reshape(t.shape[0], h, w, c).permute(0, 3, 1, 2)
        t = t.reshape(t.shape[0], -1)
    return t.contiguous().to(device)


def _init_taps(net: KfacCNNPolicy, obs_shape, device):
    """(inputs, zero perturbations) of every layer on the zero observation
    of batch 1, as flax's init leaves the ``kfac`` and ``perturbations``
    collections."""
    dtype = torch.uint8 if net.image else F32
    record = {}
    with torch.no_grad():
        net(torch.zeros((1,) + tuple(obs_shape), dtype=dtype, device=device),
            record=record)
        perts = {name: torch.zeros_like(getattr(net, name).inner(a))
                 for name, a in record.items()}
    return record, perts


def save_params(path, state: "ACKTRState") -> None:
    """Write the policy as the JAX acktr ``save_params`` writes its
    variables: ``params``, ``kfac/<layer>/a/0`` (the init's inputs) and
    ``perturbations/<layer>/g`` (zeros), in flax's layouts."""
    net = state.module
    tree = params_to_flax(net.state_dict(),
                          "kfac:cnn" if net.image else "kfac:mlp")
    tree["kfac"] = {name: {"a": {"0": _tap_to_flax(net, name, a)}}
                    for name, a in state.kfac_a.items()}
    tree["perturbations"] = {
        name: {"g": np.zeros(p.permute(0, 2, 3, 1).shape if p.ndim == 4
                             else p.shape, np.float32)}
        for name, p in state.perts.items()}
    save_flax_tree(path, tree)


def load_params(path, state: "ACKTRState") -> "ACKTRState":
    """Load an acktr file (JAX's or ``save_params``'s) into the state: the
    params, and the init inputs of its ``kfac`` collection if it has
    one."""
    tree = load_flax_tree(path)
    state.module.load_state_dict(params_from_flax(tree))
    dev = next(state.module.parameters()).device
    for name, d in tree.get("kfac", {}).items():
        state.kfac_a[name] = _tap_from_flax(state.module, name, d["a"]["0"],
                                            dev)
    return state


# ---------------------------------------------------------------------------
# make_acktr
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ACKTRState:
    """The whole training state; train_step updates it in place."""
    module: KfacCNNPolicy
    momentum: ppo.MomentumState
    kfac_a: dict        # each layer's input on the init's zero observation
    perts: dict         # the zero [1, ...] perturbation of each layer
    kfac_stats: dict    # the factors' EMA {layer: (A, S)}
    kfac_inv: dict      # the last inverses {layer: (Ainv, Sinv)}
    env_state: Any
    generator: torch.Generator
    update: int = 0

    def state_dict(self) -> dict:
        return {"params": self.module.state_dict(),
                "trace": self.momentum.trace, "kfac_a": self.kfac_a,
                "kfac_stats": self.kfac_stats, "kfac_inv": self.kfac_inv,
                "env_state": self.env_state,
                "generator": self.generator.get_state(),
                "update": self.update}

    def load_state_dict(self, d: dict) -> None:
        dev = next(self.module.parameters()).device

        def to(tree):
            return {k: tuple(x.to(dev) for x in v) if isinstance(v, tuple)
                    else v.to(dev) for k, v in tree.items()}

        self.module.load_state_dict(d["params"])
        self.momentum = ppo.MomentumState([t.to(dev) for t in d["trace"]])
        self.kfac_a = to(d["kfac_a"])
        self.kfac_stats = to(d["kfac_stats"])
        self.kfac_inv = to(d["kfac_inv"])
        self.env_state = d["env_state"]
        self.generator.set_state(d["generator"])
        self.update = int(d["update"])


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The loss, K-FAC and optimizer settings of one make_acktr."""
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    kfac_clip: float = 0.001
    damping: float = 0.01
    max_grad_norm: float = 0.5
    invert_every: int = 1
    stats_decay: float = 0.99


def kfac_step(state: ACKTRState, obs: torch.Tensor, actions: torch.Tensor,
              returns: torch.Tensor, lrnow: float, hp: Hyper,
              num_actions, mesh=None) -> dict:
    """One ACKTR step on a flat batch (obs [B, ...], actions and returns
    [B]) at update ``state.update``, in place on the state's params,
    momentum, factor EMA and inverses; returns the loss metrics and
    step_coeff (detached tensors).

    The batch is this rank's share of one spread over every rank of
    ``mesh`` (all of it for one process). The loss's means are the
    rank's sums over the whole batch's size, and one all-reduce sums the
    raw gradients, the perturbation taps and the metrics. The taps are
    sums over the batch (the perturbations have a batch of 1), so the
    Kronecker factors made from them are the whole batch's: they are
    all-reduced before the EMA.
    The A taps are the init's, alike on every rank. The EMA, the
    inversion and the step then run replicated."""
    from toybox_tpu_torch.parallel.mesh import all_reduce_tensors
    net = state.module
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    perts = {k: v.clone().requires_grad_(True) for k, v in state.perts.items()}
    logits, vpred = net(obs, perts=perts)
    n_all = obs.shape[0] * (1 if mesh is None else mesh.size)  # equal blocks

    def mean(x):
        return x.sum() / n_all

    loss, metrics = a2c.a2c_loss(logits, vpred, actions, returns,
                                 hp.ent_coef, hp.vf_coef, num_actions, mean)
    grads = torch.autograd.grad(loss, params + list(perts.values()))
    keys = sorted(metrics)
    *grads, sums = all_reduce_tensors(
        list(grads) + [torch.stack([metrics[k].detach() for k in keys])],
        mesh)
    metrics = dict(zip(keys, sums))
    raw = dict(zip(names, grads[:len(params)]))
    taps_g = dict(zip(perts, grads[len(params):]))

    meta = net.layer_meta()
    factors = kfac_factors(state.kfac_a, taps_g, meta)
    d = hp.stats_decay
    state.kfac_stats = {
        k: tuple(d * e + (1.0 - d) * f for e, f in zip(state.kfac_stats[k],
                                                        factors[k]))
        for k in factors}
    f32 = np.float32
    corr = float(f32(1.0) - f32(d) ** f32(state.update + 1))
    if state.update % hp.invert_every == 0:
        state.kfac_inv = kfac_invert(
            {k: tuple(s / corr for s in v)
             for k, v in state.kfac_stats.items()}, hp.damping)
    pre = kfac_apply(raw, state.kfac_inv, meta)

    vfv = torch.clamp(sum((pre[n] * raw[n]).sum() for n in names),
                      min=1e-12)
    coeff = torch.clamp(torch.sqrt(hp.kfac_clip / vfv), max=lrnow)
    clipped = ppo.clip_by_global_norm([pre[n] for n in names],
                                      hp.max_grad_norm)
    ppo.momentum_update(params, clipped, state.momentum, coeff)
    out = {k: v.detach() for k, v in metrics.items()}
    out["step_coeff"] = coeff.detach()
    return out


def make_acktr(env_fns, *, nsteps=20, lr=0.25, gamma=0.99, ent_coef=0.01,
               vf_coef=0.5, kfac_clip=0.001, damping=0.01,
               max_grad_norm=0.5, hidden=512, total_updates=1,
               invert_every=1, stats_decay=0.99, device="cuda", mesh=None):
    """Build (init_fn, train_step, net) over a batched env whose tensors
    lie on ``device``: init_fn(seed) -> ACKTRState (KfacCNNPolicy
    initialised as flax does, the init taps, zero momentum, factors and
    inverses, the envs reset from seeds drawn from the state's
    generator); train_step(state) -> (state, metrics), a ppo.TrainStep:
    ``collect`` the rollout and the returns, ``optimize`` kfac_step.

    With a ``mesh`` (``parallel.mesh.make_mesh``) ``env_fns`` holds this
    rank's block of the mesh's envs (built with ``seed_stride`` = all of
    them): the draws are made for the whole env
    set, alike on every rank (each rank takes its block's rows), and
    kfac_step all-reduces the gradients and the factors' taps."""
    from toybox_tpu_torch.parallel.mesh import env_block
    dev = torch.device(device)
    num_envs, nact = env_fns.num_envs, env_fns.num_actions
    envs = env_block(mesh, num_envs)
    obs_shape = tuple(env_fns.obs_shape)
    hp = Hyper(ent_coef=ent_coef, vf_coef=vf_coef, kfac_clip=kfac_clip,
               damping=damping, max_grad_norm=max_grad_norm,
               invert_every=invert_every, stats_decay=stats_decay)
    net = KfacCNNPolicy(nact, obs_shape, hidden=hidden).to(dev)
    storage = {}

    def init_fn(seed: int = 0) -> ACKTRState:
        cpu = KfacCNNPolicy(nact, obs_shape, hidden=hidden)
        init_trunk(cpu, torch.Generator().manual_seed(seed))
        net.load_state_dict(cpu.state_dict())
        kfac_a, perts = _init_taps(net, obs_shape, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        seeds = envs.take(torch.randint(0, 2**31 - 1, (envs.n_global,),
                                        generator=gen, device=dev))
        env_state, _ = env_fns.reset(seeds)
        meta = net.layer_meta()
        return ACKTRState(
            module=net,
            momentum=ppo.MomentumState.zeros_like(list(net.parameters())),
            kfac_a=kfac_a, perts=perts,
            kfac_stats=kfac_inverse_shapes(net, meta),
            kfac_inv=kfac_inverse_shapes(net, meta), env_state=env_state,
            generator=gen)

    @torch.no_grad()
    def p_step(obs, generator):
        logits, values = net(obs)
        pd = CategoricalPd(logits)
        actions = pd.sample(noise=envs.take(gumbel(
            (envs.n_global,) + tuple(logits.shape[1:]), generator,
            logits.device, logits.dtype)))
        return actions, values, pd.neglogp(actions), logits

    def collect(state: ACKTRState):
        if "buf" not in storage:
            storage["buf"] = ppo.Rollout.empty(nsteps, num_envs,
                                               state.env_state.frames)
        buf = storage["buf"]
        state.env_state = ppo.rollout(p_step, env_fns, state.env_state,
                                      state.generator, buf)
        with torch.no_grad():
            last_value = net(state.env_state.frames)[1]
        return a2c.discounted_returns(buf.rewards, buf.dones, last_value,
                                      gamma), buf

    def optimize(state: ACKTRState, collected):
        returns, buf = collected
        lrnow, _ = ppo.anneal(state.update, total_updates, lr, 0.0,
                              floor=0.05)
        metrics = kfac_step(
            state, buf.obs.reshape((-1,) + tuple(buf.obs.shape[2:])),
            buf.actions.reshape(-1), returns.reshape(-1), lrnow, hp, nact,
            mesh)
        ep = ppo.episode_metrics(buf, mesh)
        metrics.update(eprewmean=ep["eprewmean"],
                       mean_reward=ep["mean_reward"])
        state.update += 1
        return state, metrics

    return init_fn, ppo.TrainStep(collect, optimize), net


# ---------------------------------------------------------------------------
# learn()
# ---------------------------------------------------------------------------

def learn(*, env=None, game="breakout", num_envs=16, total_timesteps=100_000,
          seed=0, nsteps=20, lr=0.25, gamma=0.99, ent_coef=0.01,
          vf_coef=0.5, kfac_clip=0.001, log_interval=20, save_path=None,
          load_path=None, logger=None, updates_per_jit=1, invert_every=1,
          stats_decay=0.99, checkpoint_path=None, checkpoint_freq=500,
          network="cnn", device="cuda", **extra):
    """Train ACKTR for total_timesteps env frames; returns the ACKTRState.
    The env is built as ``ppo.learn`` builds it; TF32 is off. Updates run
    in whole blocks of ``updates_per_jit`` (the JAX recipe: 32, with
    invert_every 16 and kfac_clip 0.01). The policy is always
    KfacCNNPolicy, as in JAX: ``network`` may only name its trunk."""
    if extra:
        raise TypeError(f"learn() got unexpected arguments {sorted(extra)}")
    if network not in ("cnn", "nature_cnn"):
        raise ValueError(f"acktr trains its own KfacCNNPolicy, not "
                         f"{network!r}")
    full_f32()
    env_fns = env if env is not None else make_rl_env(
        game, num_envs, inkernel_warp=game in FRAME_KERNEL_GAMES,
        device=device)
    nbatch = env_fns.num_envs * nsteps
    fpstep = getattr(env_fns, "frames_per_step", 1)
    total_updates = max(int(total_timesteps) // (nbatch * fpstep), 1)
    init_fn, train_step, _ = make_acktr(
        env_fns, nsteps=nsteps, lr=lr, gamma=gamma, ent_coef=ent_coef,
        vf_coef=vf_coef, kfac_clip=kfac_clip, total_updates=total_updates,
        invert_every=invert_every, stats_decay=stats_decay, device=device)
    state = init_fn(seed)
    if load_path is not None:
        load_params(load_path, state)
    state = a2c.run_blocks(
        train_step, state, total_updates=total_updates,
        updates_per_jit=updates_per_jit, log_interval=log_interval,
        logger=logger, frames_per_update=nbatch * fpstep,
        checkpoint_path=checkpoint_path, checkpoint_freq=checkpoint_freq,
        sums=())
    if save_path is not None:
        save_params(save_path, state)
    return state


# ---------------------------------------------------------------------------
# Multi-rank dry run (the port's parallel.dryrun.dryrun_multichip)
# ---------------------------------------------------------------------------

def dryrun(n_devices: int, game: str = "breakout", device="cuda",
           sharded: bool = True):
    """One full ACKTR update on tiny shapes (2 envs a rank, nsteps 4, 36
    pixel frames, fc0 of 32, inverting every update), data-parallel over
    a mesh of the process group's ``n_devices`` ranks (``sharded``), or
    the same update in one process without a mesh. The env is built as
    the JAX dryrun builds it (``make_rl_env`` at 36: the fused max-pool
    kernel and the matmul warp; the in-kernel warp is fixed at 84).
    Returns (state, metrics)."""
    from toybox_tpu_torch.parallel.dryrun import dryrun_mesh
    full_f32()
    mesh = dryrun_mesh(n_devices, sharded)
    ranks = mesh.size if sharded else 1
    env_fns = make_rl_env(game, 2 * n_devices // ranks, frame_size=36,
                          seed_stride=2 * n_devices, device=device)
    init_fn, train_step, _ = make_acktr(env_fns, nsteps=4, hidden=32,
                                        invert_every=1, total_updates=1,
                                        device=device, mesh=mesh)
    return train_step(init_fn(0))

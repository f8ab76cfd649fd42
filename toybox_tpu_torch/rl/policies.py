"""PolicyWithValue, a pi + V (or pi + Q) head over a trunk, and the eval
heads of every algorithm's checkpoints (port of toybox_tpu.rl.policies:
the module, ``build_policy`` for training, ``build_eval_policy`` and
``build_recurrent_eval_policy``)."""

from __future__ import annotations

import torch
from torch import nn

from toybox_tpu_torch.rl.distributions import (CategoricalPd, gumbel,
                                               gumbel_max, make_pdtype,
                                               pd_from_logits)
from toybox_tpu_torch.rl.models import NETWORKS, RECURRENT_NETWORKS, \
    init_trunk, network_factory

__all__ = ["NETWORKS", "RECURRENT_NETWORKS", "EVAL_ALGS", "PolicyWithValue",
           "noise_step", "build_policy", "build_eval_policy", "build_recurrent_eval_policy",
           "build_eval_head", "pd_from_logits"]

#: the algorithms whose checkpoints an eval head loads (aliases included)
EVAL_ALGS = ("ppo", "ppo2", "ppo1", "a2c", "trpo", "trpo_mpi", "gail",
             "acer", "acktr", "deepq", "dqn")


class PolicyWithValue(nn.Module):
    """obs [N, ...] (uint8 NHWC images or f32 vectors) -> (logits
    [N, n_actions], value [N]); with ``estimate_q`` the value head is a Q
    head: value [N, n_actions]."""

    def __init__(self, trunk: nn.Module, n_pdparams: int,
                 latent: int | None = None, estimate_q: bool = False):
        super().__init__()
        self.trunk = trunk
        latent = trunk.latent if latent is None else latent
        self.estimate_q = estimate_q
        self.pi = nn.Linear(latent, n_pdparams)
        self.vf = nn.Linear(latent, n_pdparams if estimate_q else 1)
        self.init_heads()

    def init_heads(self, generator: torch.Generator | None = None) -> None:
        """Orthogonal heads (gain 0.01 for pi, 1 for V), zero biases."""
        with torch.no_grad():
            nn.init.orthogonal_(self.pi.weight, 0.01, generator=generator)
            nn.init.zeros_(self.pi.bias)
            nn.init.orthogonal_(self.vf.weight, 1.0, generator=generator)
            nn.init.zeros_(self.vf.bias)

    def forward(self, obs: torch.Tensor):
        latent = self.trunk(obs)
        value = self.vf(latent)
        return self.pi(latent), value if self.estimate_q else value[..., 0]


def expected_q(logits: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """E_pi[Q] = sum softmax(logits) * Q: an acer head's state value."""
    return (torch.softmax(logits, -1) * q).sum(-1)


def noise_step(forward, noise=None):
    """A rollout step_fn(obs, generator) -> (actions, values, neglogps,
    logits) over ``forward(obs) -> (logits, values)``, without gradients:
    actions are argmax(logits + g), a categorical draw, g the next of
    ``noise`` (an iterator of Gumbel noise a caller hands in, as the tests
    do with JAX's draws) or else Gumbel noise from ``generator``."""

    @torch.no_grad()
    def step_fn(obs: torch.Tensor, generator: torch.Generator):
        logits, values = forward(obs)
        g = (next(noise) if noise is not None else
             gumbel(logits.shape, generator, logits.device, logits.dtype))
        actions = gumbel_max(logits, g)
        return actions, values, CategoricalPd(logits).neglogp(actions), \
            logits

    return step_fn


def build_policy(obs_shape, action_space, network: str = "cnn",
                 device="cuda", **network_kwargs):
    """(module, init_fn, step_fn, value_fn), the training form:

    - init_fn(seed) initialises the module's parameters in place as flax
      does (lecun_normal trunk, orthogonal heads, zero biases), drawn from
      a CPU generator seeded with ``seed`` so that every device gets the
      same parameters, and returns the module;
    - step_fn(obs, generator) -> (actions, values, neglogps, logits),
      without gradients: for a discrete space ``noise_step(module)``,
      actions drawn from the categorical policy with noise from
      ``generator`` (on the module's device); for any other space
      ``make_pdtype`` takes, drawn by its distribution's ``sample``;
    - value_fn(obs) -> values, without gradients.
    """
    n_pdparams, make_pd = make_pdtype(action_space)
    trunk = network_factory(network)(tuple(obs_shape), **network_kwargs)
    module = PolicyWithValue(trunk, n_pdparams).to(device)

    def init_fn(seed: int = 0) -> PolicyWithValue:
        gen = torch.Generator().manual_seed(seed)
        cpu = PolicyWithValue(
            network_factory(network)(tuple(obs_shape), **network_kwargs),
            n_pdparams)
        init_trunk(cpu.trunk, gen)
        cpu.init_heads(gen)
        module.load_state_dict(cpu.state_dict())
        return module

    @torch.no_grad()
    def value_fn(obs: torch.Tensor) -> torch.Tensor:
        return module(obs)[1]

    @torch.no_grad()
    def pd_step(obs: torch.Tensor, generator: torch.Generator):
        logits, values = module(obs)
        pd = make_pd(logits)
        actions = pd.sample(generator)
        return actions, values, pd.neglogp(actions), logits

    step_fn = noise_step(module) if make_pd is CategoricalPd else pd_step
    return module, init_fn, step_fn, value_fn


def _check_alg(alg: str) -> None:
    if alg not in EVAL_ALGS:
        raise ValueError(f"unknown alg {alg!r}; the eval heads load "
                         f"{', '.join(EVAL_ALGS)}")


def _eval_module(make, seed: int, device):
    """The module ``make()`` builds on the CPU with torch's RNG seeded
    from ``seed`` (a random policy for smoke runs; load a checkpoint into
    it with ``load_state_dict``), moved to ``device`` in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = make()
    return module.to(device).eval()


def build_eval_policy(alg: str, obs_shape, n_actions: int,
                      network: str = "cnn", seed: int = 0, device="cuda",
                      **network_kwargs):
    """(module, step_fn) able to load ``alg``'s feed-forward checkpoint:

    - ppo/ppo2, ppo1, a2c, trpo/trpo_mpi, gail: PolicyWithValue (pi + V);
    - acer: PolicyWithValue(estimate_q=True); the value is E_pi[Q];
    - acktr: KfacCNNPolicy (``network`` is not read, as in JAX);
    - deepq/dqn: the dueling QNetwork; actions are eps-greedy (eps 0.01
      unless step_fn is given ``eps``), the value is max Q and the fourth
      output is Q.

    step_fn(obs, generator) -> (actions, values, neglogps, logits or Q),
    without gradients, the draws from ``generator``."""
    _check_alg(alg)
    if network in RECURRENT_NETWORKS:
        raise ValueError(f"{network!r} is recurrent: use "
                         "build_recurrent_eval_policy")
    shape = tuple(obs_shape)
    if alg in ("deepq", "dqn"):
        from toybox_tpu_torch.rl.dqn import QNetwork, epsilon_greedy

        module = _eval_module(lambda: QNetwork(
            network_factory(network)(shape, **network_kwargs), n_actions),
            seed, device)

        @torch.no_grad()
        def q_step(obs, generator, eps: float = 0.01):
            q = module(obs)
            actions = epsilon_greedy(q, eps, generator)
            return actions, q.max(-1).values, torch.zeros_like(q[:, 0]), q

        return module, q_step
    if alg == "acktr":
        from toybox_tpu_torch.rl.acktr import KfacCNNPolicy

        module = _eval_module(lambda: KfacCNNPolicy(n_actions, shape),
                              seed, device)
    elif alg == "acer":
        module = _eval_module(lambda: PolicyWithValue(
            network_factory(network)(shape, **network_kwargs), n_actions,
            estimate_q=True), seed, device)
    else:
        module = _eval_module(lambda: build_policy(
            shape, n_actions, network, device="cpu", **network_kwargs)[0],
            seed, device)

    @torch.no_grad()
    def step_fn(obs, generator):
        logits, value = module(obs)
        pd = CategoricalPd(logits)
        actions = pd.sample(generator)
        if value.ndim == 2:                     # acer: Q -> E_pi[Q]
            value = expected_q(logits, value)
        return actions, value, pd.neglogp(actions), logits

    return module, step_fn


def build_recurrent_eval_policy(obs_shape, n_actions: int, network: str,
                                nlstm: int = 128, alg: str = "ppo",
                                seed: int = 0, device="cuda",
                                **network_kwargs):
    """(module, step_fn) able to load a recurrent checkpoint (ppo_lstm,
    a2c_lstm, ppo_lnlstm: RecurrentPolicyWithValue; acer_lstm:
    RecurrentQPolicy, whose value is E_pi[Q]).

    step_fn(obs, generator, carry, prev_done) -> (actions, values,
    neglogps, new_carry), without gradients: ``prev_done`` flags the envs
    whose episode ended at the previous step (their carry restarts from
    zero). ``module.initial_carry(n)`` is the first carry."""
    _check_alg(alg)
    if network not in RECURRENT_NETWORKS:
        raise ValueError(f"{network!r} is not recurrent; have "
                         f"{RECURRENT_NETWORKS}")
    shape = tuple(obs_shape)

    def make():
        trunk = network_factory(network)(shape, nlstm=nlstm,
                                         **network_kwargs)
        if alg == "acer":
            from toybox_tpu_torch.rl.acer import RecurrentQPolicy
            return RecurrentQPolicy(trunk, n_actions)
        from toybox_tpu_torch.rl.ppo_recurrent import \
            RecurrentPolicyWithValue
        return RecurrentPolicyWithValue(trunk, n_actions)

    module = _eval_module(make, seed, device)

    @torch.no_grad()
    def step_fn(obs, generator, carry, prev_done):
        logits, value, new_carry = module(obs, carry, prev_done)
        pd = CategoricalPd(logits)
        actions = pd.sample(generator)
        if value.ndim == 2:                     # acer: Q -> E_pi[Q]
            value = expected_q(logits, value)
        return actions, value, pd.neglogp(actions), new_carry

    return module, step_fn


def build_eval_head(alg: str, obs_shape, n_actions: int, network: str,
                    nlstm: int = 128, seed: int = 0, device="cuda"):
    """(module, step_fn) of ``alg``'s eval head: the recurrent one
    (``build_recurrent_eval_policy``) for a recurrent network, else
    ``build_eval_policy``'s."""
    if network in RECURRENT_NETWORKS:
        return build_recurrent_eval_policy(obs_shape, n_actions, network,
                                           nlstm=nlstm, alg=alg, seed=seed,
                                           device=device)
    return build_eval_policy(alg, obs_shape, n_actions, network, seed=seed,
                             device=device)

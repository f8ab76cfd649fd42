"""PolicyWithValue, a pi + V head over a trunk (port of
toybox_tpu.rl.policies: the module, ``build_policy`` for training and the
``ppo`` branch of ``build_eval_policy``)."""

from __future__ import annotations

import torch
from torch import nn

from toybox_tpu_torch.rl.distributions import make_pdtype
from toybox_tpu_torch.rl.models import NETWORKS, network_factory, \
    init_trunk

__all__ = ["NETWORKS", "PolicyWithValue", "build_policy",
           "build_eval_policy"]


class PolicyWithValue(nn.Module):
    """obs [N, ...] (uint8 NHWC images or f32 vectors) -> (logits
    [N, n_actions], value [N])."""

    def __init__(self, trunk: nn.Module, n_pdparams: int,
                 latent: int | None = None):
        super().__init__()
        self.trunk = trunk
        latent = trunk.latent if latent is None else latent
        self.pi = nn.Linear(latent, n_pdparams)
        self.vf = nn.Linear(latent, 1)
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
        return self.pi(latent), self.vf(latent)[..., 0]


def build_policy(obs_shape, action_space, network: str = "cnn",
                 device="cuda", **network_kwargs):
    """(module, init_fn, step_fn, value_fn), the training form:

    - init_fn(seed) initialises the module's parameters in place as flax
      does (lecun_normal trunk, orthogonal heads, zero biases), drawn from
      a CPU generator seeded with ``seed`` so that every device gets the
      same parameters, and returns the module;
    - step_fn(obs, generator) -> (actions, values, neglogps, logits),
      without gradients, actions drawn from the categorical policy with
      noise from ``generator`` (on the module's device);
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
    def step_fn(obs: torch.Tensor, generator: torch.Generator):
        logits, value = module(obs)
        pd = make_pd(logits)
        actions = pd.sample(generator)
        return actions, value, pd.neglogp(actions), logits

    @torch.no_grad()
    def value_fn(obs: torch.Tensor) -> torch.Tensor:
        return module(obs)[1]

    return module, init_fn, step_fn, value_fn


def build_eval_policy(alg: str, obs_shape, n_actions: int,
                      network: str = "cnn", seed: int = 0, device="cuda"):
    """(module, step_fn) able to load a ppo checkpoint for evaluation.

    step_fn(obs, generator) -> (actions, values, neglogps, logits), with
    actions sampled from the categorical policy. The module is initialised
    from ``seed``; load a checkpoint into it with ``load_state_dict``."""
    if alg not in ("ppo", "ppo2"):
        raise NotImplementedError(f"alg {alg!r} is not ported yet (ppo only)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module, _, step_fn, _ = build_policy(obs_shape, n_actions, network,
                                             device="cpu")
    module.to(device).eval()
    return module, step_fn

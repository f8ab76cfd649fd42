"""PolicyWithValue, a pi + V head over a trunk (port of
toybox_tpu.rl.policies: the module and the ``ppo`` branch of
``build_eval_policy``)."""

from __future__ import annotations

import torch
from torch import nn

from toybox_tpu_torch.rl.distributions import CategoricalPd
from toybox_tpu_torch.rl.models import NatureCNN

NETWORKS = {"cnn": NatureCNN}


class PolicyWithValue(nn.Module):
    """obs uint8 NHWC [N, H, W, C] -> (logits [N, n_actions], value [N])."""

    def __init__(self, trunk: nn.Module, n_pdparams: int, latent: int = 512):
        super().__init__()
        self.trunk = trunk
        self.pi = nn.Linear(latent, n_pdparams)
        self.vf = nn.Linear(latent, 1)
        nn.init.orthogonal_(self.pi.weight, 0.01)
        nn.init.zeros_(self.pi.bias)
        nn.init.orthogonal_(self.vf.weight, 1.0)
        nn.init.zeros_(self.vf.bias)

    def forward(self, obs: torch.Tensor):
        latent = self.trunk(obs.permute(0, 3, 1, 2))
        return self.pi(latent), self.vf(latent)[..., 0]


def build_eval_policy(alg: str, obs_shape, n_actions: int,
                      network: str = "cnn", seed: int = 0, device="cuda"):
    """(module, step_fn) able to load a ppo checkpoint for evaluation.

    step_fn(obs, generator) -> (actions, values, neglogps, logits), with
    actions sampled from the categorical policy. The module is initialised
    from ``seed``; load a checkpoint into it with ``load_state_dict``."""
    if alg not in ("ppo", "ppo2"):
        raise NotImplementedError(f"alg {alg!r} is not ported yet (ppo only)")
    if network not in NETWORKS:
        raise NotImplementedError(f"network {network!r} is not ported yet")
    h, w, c = obs_shape
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = PolicyWithValue(NETWORKS[network](c, h, w), n_actions)
    module = module.to(device).eval()

    @torch.no_grad()
    def step_fn(obs: torch.Tensor, generator: torch.Generator):
        logits, value = module(obs)
        pd = CategoricalPd(logits)
        actions = pd.sample(generator)
        return actions, value, pd.neglogp(actions), logits

    return module, step_fn

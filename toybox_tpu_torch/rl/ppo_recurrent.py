"""The recurrent pi + V policy (port of toybox_tpu.rl.ppo_recurrent
``RecurrentPolicyWithValue``; the recurrent learner is not ported yet)."""

from __future__ import annotations

import torch
from torch import nn


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

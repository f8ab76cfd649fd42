"""The recurrent acer policy (port of toybox_tpu.rl.acer
``RecurrentQPolicy``; the learner and its replay are not ported yet)."""

from __future__ import annotations

import torch
from torch import nn


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

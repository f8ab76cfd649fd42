"""The deepq Q network (port of toybox_tpu.rl.dqn ``QNetwork``; the
replay buffer and the learner are not ported yet)."""

from __future__ import annotations

import torch
from torch import nn


class QNetwork(nn.Module):
    """obs -> Q [N, n_actions], dueling: a trunk, then an advantage stream
    (Dense ``hiddens`` with relu, Dense n_actions) and a state value
    stream (Dense ``hiddens`` with relu, Dense 1), combined as
    V + A - mean(A). (The JAX module's ``dueling=False`` form has no
    committed checkpoint and comes with the learner.)"""

    def __init__(self, trunk: nn.Module, n_actions: int, hiddens: int = 256):
        super().__init__()
        self.trunk = trunk
        self.adv_hidden = nn.Linear(trunk.latent, hiddens)
        self.adv_out = nn.Linear(hiddens, n_actions)
        self.val_hidden = nn.Linear(trunk.latent, hiddens)
        self.val_out = nn.Linear(hiddens, 1)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        latent = self.trunk(obs)
        scores = self.adv_out(torch.relu(self.adv_hidden(latent)))
        value = self.val_out(torch.relu(self.val_hidden(latent)))
        return value + (scores - scores.mean(-1, keepdim=True))

"""Categorical action distribution (port of
toybox_tpu.rl.distributions ``CategoricalPd``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class CategoricalPd:
    logits: torch.Tensor  # [..., n]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Gumbel-max draw with noise from ``generator`` (on the logits'
        device)."""
        u = torch.rand(self.logits.shape, generator=generator,
                       device=self.logits.device, dtype=self.logits.dtype)
        u = u.clamp_min(torch.finfo(u.dtype).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def neglogp(self, actions: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -logp.gather(-1, actions.long()[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(logp.exp() * logp).sum(-1)

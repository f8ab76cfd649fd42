"""Categorical action distribution (port of
toybox_tpu.rl.distributions ``CategoricalPd`` and ``make_pdtype`` for a
discrete action space), and the standard Gumbel noise its draws use."""

from __future__ import annotations

import dataclasses

import torch


def gumbel(shape, generator: torch.Generator, device,
           dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform from ``generator``
    (kept above the dtype's smallest normal number)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def gumbel_max(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """argmax(logits + noise): a categorical draw when ``noise`` is
    standard Gumbel noise. Tests hand it the JAX draw's noise."""
    return torch.argmax(logits + noise, dim=-1)


@dataclasses.dataclass(frozen=True)
class CategoricalPd:
    logits: torch.Tensor  # [..., n]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Gumbel-max draw with noise from ``generator`` (on the logits'
        device)."""
        return gumbel_max(self.logits, gumbel(
            self.logits.shape, generator, self.logits.device,
            self.logits.dtype))

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def neglogp(self, actions: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -logp.gather(-1, actions.long()[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(logp.exp() * logp).sum(-1)

    def kl(self, other: "CategoricalPd") -> torch.Tensor:
        """KL(self || other) over the last axis."""
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        return (logp.exp() * (logp - logq)).sum(-1)


def make_pdtype(space):
    """(n_params, distribution class) for an int action count or a Discrete space
    (an object with ``n``); other spaces are not ported yet."""
    if isinstance(space, int):
        n = space
    elif type(space).__name__ == "Discrete":
        n = int(space.n)
    else:
        raise NotImplementedError(f"no pdtype for space {space} (only "
                                  "discrete action spaces are ported)")
    return n, CategoricalPd


def pd_from_logits(space, logits: torch.Tensor) -> CategoricalPd:
    _, pd_class = make_pdtype(space)
    return pd_class(logits)

"""Action distributions (port of toybox_tpu.rl.distributions:
``CategoricalPd``, ``MultiCategoricalPd``, ``DiagGaussianPd``,
``BernoulliPd`` and ``make_pdtype`` from a gym space), and the standard
Gumbel noise the categorical draws use.

Every ``sample`` takes its randomness explicitly: a ``torch.Generator``
(on the parameters' device), or the noise itself (``noise=``), which the
tests feed with the JAX draws' noise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


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

    def sample(self, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """Gumbel-max draw with ``noise`` (standard Gumbel, the logits'
        shape) or else noise from ``generator`` (on the logits' device)."""
        if noise is None:
            noise = gumbel(self.logits.shape, generator, self.logits.device,
                           self.logits.dtype)
        return gumbel_max(self.logits, noise)

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


@dataclasses.dataclass(frozen=True)
class MultiCategoricalPd:
    """One categorical per sub-space: ``logits`` [..., sum(ncats)] split
    in order by ``ncats``; actions [..., len(ncats)]."""
    logits: torch.Tensor
    ncats: tuple

    def _split(self) -> list:
        return [CategoricalPd(x) for x in
                torch.split(self.logits, list(self.ncats), dim=-1)]

    def sample(self, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """One Gumbel-max draw per split; ``noise`` has the logits' shape
        (each split's noise in its columns)."""
        if noise is None:
            noise = gumbel(self.logits.shape, generator, self.logits.device,
                           self.logits.dtype)
        parts = torch.split(noise, list(self.ncats), dim=-1)
        return torch.stack([pd.sample(noise=g) for pd, g in
                            zip(self._split(), parts)], dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.stack([pd.mode() for pd in self._split()], dim=-1)

    def neglogp(self, actions: torch.Tensor) -> torch.Tensor:
        return sum(pd.neglogp(actions[..., i])
                   for i, pd in enumerate(self._split()))

    def entropy(self) -> torch.Tensor:
        return sum(pd.entropy() for pd in self._split())

    def kl(self, other: "MultiCategoricalPd") -> torch.Tensor:
        """The sum of the splits' KLs (the reference's; JAX's class has no
        kl)."""
        return sum(p.kl(q) for p, q in zip(self._split(), other._split()))


@dataclasses.dataclass(frozen=True)
class DiagGaussianPd:
    mean: torch.Tensor
    logstd: torch.Tensor

    def sample(self, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """mean + exp(logstd) * noise, ``noise`` standard normal."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + torch.exp(self.logstd) * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def neglogp(self, x: torch.Tensor) -> torch.Tensor:
        return (0.5 * torch.square((x - self.mean)
                                   / torch.exp(self.logstd)).sum(-1)
                + 0.5 * _LOG_2PI * x.shape[-1]
                + self.logstd.sum(-1))

    def entropy(self) -> torch.Tensor:
        return (self.logstd + 0.5 * (_LOG_2PI + 1.0)).sum(-1)

    def kl(self, other: "DiagGaussianPd") -> torch.Tensor:
        return (other.logstd - self.logstd
                + (torch.exp(2 * self.logstd)
                   + torch.square(self.mean - other.mean))
                / (2.0 * torch.exp(2 * other.logstd)) - 0.5).sum(-1)


@dataclasses.dataclass(frozen=True)
class BernoulliPd:
    logits: torch.Tensor

    def _ps(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def sample(self, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """(u < sigmoid(logits)) as int32, ``noise`` the uniforms u."""
        if noise is None:
            noise = torch.rand(self.logits.shape, generator=generator,
                               device=self.logits.device)
        return (noise < self._ps()).to(torch.int32)

    def mode(self) -> torch.Tensor:
        return (self._ps() > 0.5).to(torch.int32)

    def neglogp(self, x: torch.Tensor) -> torch.Tensor:
        """The sigmoid cross-entropy of ``x`` summed over the last axis."""
        x = x.to(self.logits.dtype)
        return (torch.clamp_min(self.logits, 0) - self.logits * x
                + torch.log1p(torch.exp(-self.logits.abs()))).sum(-1)

    def entropy(self) -> torch.Tensor:
        p, eps = self._ps(), 1e-8
        return -(p * torch.log(p + eps)
                 + (1 - p) * torch.log(1 - p + eps)).sum(-1)

    def kl(self, other: "BernoulliPd") -> torch.Tensor:
        """The reference's: cross-entropy of self's probabilities under
        other minus under self (JAX's class has no kl)."""
        p = self._ps()
        return other.neglogp(p) - self.neglogp(p)


def make_pdtype(space):
    """(n_params, make_pd): the flat parameter count and ``make_pd(flat)
    -> distribution`` of an int action count or a gym(nasium) space
    (Discrete, MultiDiscrete, Box: mean and logstd halves, MultiBinary).
    Any other space raises NotImplementedError, as in JAX."""
    if isinstance(space, int):
        return space, CategoricalPd
    clsname = type(space).__name__
    if clsname == "Discrete":
        return int(space.n), CategoricalPd
    if clsname == "MultiDiscrete":
        ncats = tuple(int(x) for x in space.nvec)
        return sum(ncats), lambda flat: MultiCategoricalPd(flat, ncats)
    if clsname == "Box":
        size = math.prod(int(d) for d in space.shape)

        def build(flat):
            mean, logstd = torch.chunk(flat, 2, dim=-1)
            return DiagGaussianPd(mean, logstd)
        return 2 * size, build
    if clsname == "MultiBinary":
        return int(space.n), BernoulliPd
    raise NotImplementedError(f"no pdtype for space {space}")


def pd_from_logits(space, logits: torch.Tensor):
    _, make_pd = make_pdtype(space)
    return make_pd(logits)

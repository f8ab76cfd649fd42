"""The layers of the K-FAC policies (port of toybox_tpu.rl.kfac
``KfacDense`` and ``KfacConv``) as plain layers, each holding its
``inner`` Dense or Conv as the flax modules name it.

The JAX layers also tap their inputs (``sow``) and their pre-activation
gradients (``perturb``) for the K-FAC learner; the eval forward reads
neither, and the taps come with the acktr learner."""

from __future__ import annotations

import torch
from torch import nn


class KfacDense(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.inner = nn.Linear(in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner(x)


class KfacConv(nn.Module):
    """A VALID convolution over NCHW."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int):
        super().__init__()
        self.inner = nn.Conv2d(in_channels, features, kernel, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inner(x)

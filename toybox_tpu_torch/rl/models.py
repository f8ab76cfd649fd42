"""Policy trunks (port of toybox_tpu.rl.models: ``NatureCNN`` and ``MLP``,
in a name registry as the JAX package keeps them).

Each trunk takes the observation as the JAX package lays it out (NHWC
images, flat vectors) and returns f32[N, latent]. Convolutions run in
NCHW, PyTorch's layout: NatureCNN turns the NHWC observation view back
into the channel-first stack it came from.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


def _norm_obs(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


class NatureCNN(nn.Module):
    """The Mnih et al. DQN/A3C trunk: uint8 NHWC [N, H, W, C] ->
    f32[N, 512]."""

    def __init__(self, in_channels: int = 4, height: int = 84,
                 width: int = 84):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, 32, 8, stride=4)
        self.conv1 = nn.Conv2d(32, 64, 4, stride=2)
        self.conv2 = nn.Conv2d(64, 64, 3, stride=1)
        h, w = height, width
        for k, s in ((8, 4), (4, 2), (3, 1)):
            h, w = _conv_out(h, k, s), _conv_out(w, k, s)
        self.out_hw = (h, w)
        self.fc = nn.Linear(64 * h * w, 512)
        self.latent = 512

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_obs(x.permute(0, 3, 1, 2))
        x = torch.relu(self.conv0(x))
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return torch.relu(self.fc(x.flatten(1)))


class MLP(nn.Module):
    """The reference models.py mlp: flatten, then ``num_layers`` Dense
    layers of ``num_hidden`` units with tanh."""

    def __init__(self, in_features: int, num_layers: int = 2,
                 num_hidden: int = 64):
        super().__init__()
        sizes = [in_features] + [num_hidden] * num_layers
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.latent = sizes[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_obs(x).flatten(1)
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return x


def _nature_cnn(obs_shape, **kwargs):
    h, w, c = obs_shape
    return NatureCNN(c, h, w, **kwargs)


def _mlp(obs_shape, **kwargs):
    return MLP(math.prod(obs_shape), **kwargs)


NETWORKS = {"cnn": _nature_cnn, "mlp": _mlp}


def network_factory(name: str):
    """factory(obs_shape, **network_kwargs) -> trunk module with a
    ``latent`` width."""
    try:
        return NETWORKS[name]
    except KeyError:
        raise NotImplementedError(
            f"network {name!r} is not ported yet; have "
            f"{sorted(NETWORKS)}") from None


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init: a normal of variance 1 / fan_in cut at
    two standard deviations (its stddev rescaled for the cut)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def init_trunk(trunk: nn.Module, generator: torch.Generator) -> None:
    """Every Conv2d and Linear of the trunk as flax initialises nn.Conv
    and nn.Dense: lecun_normal kernels, zero biases."""
    for m in trunk.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)

"""Policy trunks (port of toybox_tpu.rl.models; ``NatureCNN`` only).

Convolutions run in NCHW, PyTorch's layout; the policy turns the NHWC
observation view back into the channel-first stack it came from.
"""

from __future__ import annotations

import torch
from torch import nn


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


class NatureCNN(nn.Module):
    """The Mnih et al. DQN/A3C trunk: uint8 NCHW [N, C, H, W] -> f32[N, 512]."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        else:
            x = x.to(torch.float32)
        x = torch.relu(self.conv0(x))
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return torch.relu(self.fc(x.flatten(1)))

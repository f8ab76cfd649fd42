"""The acktr policy network (port of toybox_tpu.rl.acktr
``KfacCNNPolicy``; the K-FAC learner is not ported yet)."""

from __future__ import annotations

import torch
from torch import nn

from toybox_tpu_torch.rl.kfac import KfacConv, KfacDense
from toybox_tpu_torch.rl.models import NATURE_CONVS, _conv_out, _norm_obs


class KfacCNNPolicy(nn.Module):
    """uint8 NHWC obs (``obs_shape`` (h, w, c)) -> (logits [N, n_actions],
    value [N]): NatureCNN's convolutions ``conv0..2`` and a Dense ``fc0``
    of ``hidden`` units, all with relu, then heads ``pi`` and ``vf``. (The
    JAX module's flat-vector form, ``fc0`` alone, has no committed
    checkpoint and comes with the learner.)"""

    def __init__(self, n_actions: int, obs_shape=(84, 84, 4),
                 convs=NATURE_CONVS, hidden: int = 512):
        super().__init__()
        h, w, c = obs_shape
        for i, (ch, k, s) in enumerate(convs):
            setattr(self, f"conv{i}", KfacConv(c, ch, k, s))
            h, w, c = _conv_out(h, k, s), _conv_out(w, k, s), ch
        self.n_convs = len(convs)
        self.fc0 = KfacDense(c * h * w, hidden)
        self.pi = KfacDense(hidden, n_actions)
        self.vf = KfacDense(hidden, 1)

    def forward(self, obs: torch.Tensor):
        x = _norm_obs(obs.permute(0, 3, 1, 2))
        for i in range(self.n_convs):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        x = torch.relu(self.fc0(x.flatten(1)))
        return self.pi(x), self.vf(x)[..., 0]

"""K-FAC, Kronecker-factored approximate curvature (port of
toybox_tpu.rl.kfac: the layers ``KfacDense`` and ``KfacConv``, and
``kfac_factors``, ``kfac_invert``, ``kfac_apply``,
``kfac_inverse_shapes`` and ``kfac_precondition``).

Per layer with weight W [in, out] (the bias folded in by augmenting the
input with a 1):
  A = E[a_bar a_bar^T]   (the input's second moment, a_bar = [a, 1])
  S = E[g g^T]           (the pre-activation gradient's second moment)
  preconditioned gradient = A^-1 dW S^-1   (with Tikhonov damping)
and a convolution the same over its input patches (KFC).

The JAX layers tap their input with ``sow`` and their pre-activation
gradient with ``perturb``. Here a layer takes an optional perturbation,
added to its pre-activation output: the gradient of the loss with respect
to it is that tap. ``KfacCNNPolicy`` (rl/acktr.py) records each layer's
input. Layouts are the port's: a conv input a [N, Cin, H, W] and its tap
g [N, Cout, Ho, Wo]; gradients keyed by state_dict name, Linear weights
[out, in] and Conv2d weights [Cout, Cin, kh, kw].

The JAX package's own ordering is kept where it does not pair up:
``conv_general_dilated_patches`` lays each patch out in (cin, kh, kw)
order, as ``F.unfold`` does here, while ``kfac_apply`` flattens the conv
kernel's gradient in HWIO, (kh, kw, cin), order. So for a conv with more
than one input channel the coordinates of A and the rows of the gradient
it multiplies are ordered differently; the models in models/ were trained
so, and the port reproduces it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

F32 = torch.float32


class KfacDense(nn.Module):
    """A Dense layer (``inner``, as the flax module names it); ``pert``,
    when given, is added to its output."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.inner = nn.Linear(in_features, features)

    def forward(self, x: torch.Tensor, pert=None) -> torch.Tensor:
        y = self.inner(x)
        return y if pert is None else y + pert


class KfacConv(nn.Module):
    """A VALID convolution over NCHW (``inner``); ``pert``, when given, is
    added to its output."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int):
        super().__init__()
        self.inner = nn.Conv2d(in_channels, features, kernel, stride=stride)

    def forward(self, x: torch.Tensor, pert=None) -> torch.Tensor:
        y = self.inner(x)
        return y if pert is None else y + pert


def _augment(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                    device=x.device)], dim=1)


def _factors_dense(a: torch.Tensor, g: torch.Tensor):
    """a [N, in], g [N, out] -> (A [in+1, in+1], S [out, out], N)."""
    n = a.shape[0]
    a_bar = _augment(a)
    return (a_bar.T @ a_bar) / n, (g.T @ g) / n, n


def _factors_conv(a: torch.Tensor, g: torch.Tensor, kernel: int,
                  stride: int):
    """a [N, Cin, H, W], g [N, Cout, Ho, Wo] -> the Kronecker factors over
    the input's patches (KFC): A over (cin, kh, kw)-ordered patch features
    plus the 1, S over output channels scaled by the number of positions
    T = Ho * Wo."""
    n = a.shape[0]
    patches = F.unfold(a.to(F32), kernel, stride=stride)  # [N, k*k*Cin, T]
    t = patches.shape[-1]
    p = patches.transpose(1, 2).reshape(-1, patches.shape[1])
    gg = g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])
    p_bar = _augment(p)
    A = (p_bar.T @ p_bar) / p.shape[0]
    S = (gg.T @ gg) / p.shape[0] * t
    return A, S, n


def _damped_inv(M: torch.Tensor, damping) -> torch.Tensor:
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    return torch.linalg.inv(M + damping * eye)


def kfac_factors(taps_a: dict, taps_g: dict, layer_meta: dict) -> dict:
    """Per-layer Kronecker factors {name: (A, S)} from each layer's input
    tap (``taps_a``) and pre-activation gradient tap (``taps_g``);
    layer_meta: {name: ("dense",) | ("conv", kernel, stride)}."""
    out = {}
    for name, meta in layer_meta.items():
        a, g = taps_a[name], taps_g[name]
        if meta[0] == "dense":
            A, S, _ = _factors_dense(a, g)
        else:
            A, S, _ = _factors_conv(a, g, meta[1], meta[2])
        out[name] = (A, S)
    return out


def kfac_invert(factors: dict, damping: float = 0.01) -> dict:
    """Damped inverses {name: (Ainv, Sinv)}, the damping split between the
    two factors by the trace-balanced pi (Martens & Grosse). The O(n^3)
    step: callers refresh it every few updates."""
    out = {}
    for name, (A, S) in factors.items():
        pi = torch.sqrt((torch.trace(A) / A.shape[0])
                        / torch.clamp(torch.trace(S) / S.shape[0],
                                      min=1e-8))
        out[name] = (_damped_inv(A, damping * pi),
                     _damped_inv(S, damping / torch.clamp(pi, min=1e-8)))
    return out


def kfac_apply(grads: dict, inverses: dict, layer_meta: dict) -> dict:
    """grads (state_dict name -> gradient) with each K-FAC layer's weight
    and bias gradients replaced by Ainv @ G @ Sinv, G the JAX kernel's
    gradient with the bias's as its last row ([in, out] for a Dense, the
    HWIO kernel flattened to [kh*kw*cin, cout] for a conv). Other entries
    keep their gradients."""
    out = dict(grads)
    for name, meta in layer_meta.items():
        dW, db = grads[f"{name}.inner.weight"], grads[f"{name}.inner.bias"]
        Ainv, Sinv = inverses[name]
        if meta[0] == "dense":
            P = Ainv @ torch.cat([dW.T, db[None]]) @ Sinv
            pW = P[:-1].T
        else:
            hwio = dW.permute(2, 3, 1, 0)
            G = torch.cat([hwio.reshape(-1, hwio.shape[-1]), db[None]])
            P = Ainv @ G @ Sinv
            pW = P[:-1].reshape(hwio.shape).permute(3, 2, 0, 1)
        out[f"{name}.inner.weight"] = pW.contiguous()
        out[f"{name}.inner.bias"] = P[-1]
    return out


def kfac_inverse_shapes(module: nn.Module, layer_meta: dict) -> dict:
    """Zero {name: (Ainv, Sinv)} of kfac_invert's shapes on the module's
    device: the state before the first refresh (and the EMA's start)."""
    out = {}
    for name, meta in layer_meta.items():
        w = getattr(module, name).inner.weight
        din, dout = w[0].numel() + 1, w.shape[0]
        out[name] = (torch.zeros((din, din), dtype=F32, device=w.device),
                     torch.zeros((dout, dout), dtype=F32, device=w.device))
    return out


def kfac_precondition(grads: dict, taps_a: dict, taps_g: dict,
                      layer_meta: dict, damping: float = 0.01) -> dict:
    """factors -> invert -> apply in one call (it inverts every call; to
    invert less often, keep kfac_invert's output and call kfac_apply)."""
    factors = kfac_factors(taps_a, taps_g, layer_meta)
    return kfac_apply(grads, kfac_invert(factors, damping), layer_meta)

"""Policy trunks (port of toybox_tpu.rl.models: ``NatureCNN``,
``SmallCNN``, ``ConvOnly``, ``MLP``, ``LSTMTrunk`` and the two layout
variants of NatureCNN, ``Im2ColCNN`` and ``CoutPadCNN``, in a name
registry as the JAX package keeps them).

Each trunk takes the observation as the JAX package lays it out (NHWC
images, flat vectors) and returns f32[N, latent]. Convolutions run in
NCHW, PyTorch's layout: the convolutional trunks turn the NHWC
observation view back into the channel-first stack it came from, and
flatten their feature maps as (c, h, w) where flax flattens (h, w, c)
(``rl/checkpoint.py`` reorders the Dense rows that read them).

The ``dtype`` network kwarg (a torch dtype or its name, e.g.
``"bfloat16"``) computes a trunk in that dtype over f32 parameters, as
flax's ``dtype=`` does; the trunk's output is f32. Recurrent trunks
(``cnn_lstm``, ``cnn_lnlstm``, ``lstm``) take ``(obs, carry, done)`` and
return ``(latent, new_carry)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


def _norm_obs(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x.to(dtype) / 255.0
    return x.to(dtype)


def _apply(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d or Linear in the dtype of ``x``: its f32 parameters are
    cast to it first, as flax promotes them to the module's dtype."""
    if x.dtype == layer.weight.dtype:
        return layer(x)
    w, b = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
    if isinstance(layer, nn.Conv2d):
        return F.conv2d(x, w, b, layer.stride)
    return F.linear(x, w, b)


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from itself or its name (``"bfloat16"``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {dtype!r}")
    return dtype


class ConvStack(nn.Module):
    """VALID convolutions with relu over uint8 NHWC [N, H, W, C], then,
    with ``hidden``, a Dense layer with relu: the shared body of NatureCNN
    (``convs`` the Mnih et al. three, hidden 512), SmallCNN (two, hidden
    128) and ConvOnly (the three, flattened, no Dense)."""

    def __init__(self, convs, in_channels: int, height: int, width: int,
                 hidden: int | None, dtype=torch.float32):
        super().__init__()
        self.dtype = as_dtype(dtype)
        h, w, c = height, width, in_channels
        for i, (ch, k, s) in enumerate(convs):
            setattr(self, f"conv{i}", nn.Conv2d(c, ch, k, stride=s))
            h, w, c = _conv_out(h, k, s), _conv_out(w, k, s), ch
        self.n_convs = len(convs)
        self.out_chw = (c, h, w)
        flat = c * h * w
        if hidden is not None:
            self.fc = nn.Linear(flat, hidden)
        self.latent = flat if hidden is None else hidden

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_obs(x.permute(0, 3, 1, 2), self.dtype)
        for i in range(self.n_convs):
            x = torch.relu(_apply(getattr(self, f"conv{i}"), x))
        x = x.flatten(1)
        if hasattr(self, "fc"):
            x = torch.relu(_apply(self.fc, x))
        return x.to(torch.float32)


NATURE_CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
SMALL_CONVS = ((8, 8, 4), (16, 4, 2))


class NatureCNN(ConvStack):
    """The Mnih et al. DQN/A3C trunk: uint8 NHWC [N, H, W, C] ->
    f32[N, 512]."""

    def __init__(self, in_channels: int = 4, height: int = 84,
                 width: int = 84, dtype=torch.float32):
        super().__init__(NATURE_CONVS, in_channels, height, width, 512,
                         dtype)


class SmallCNN(ConvStack):
    """The reference cnn_small: 8x8/4 -> 8, 4x4/2 -> 16, Dense 128."""

    def __init__(self, in_channels: int = 4, height: int = 84,
                 width: int = 84, dtype=torch.float32):
        super().__init__(SMALL_CONVS, in_channels, height, width, 128,
                         dtype)


class ConvOnly(ConvStack):
    """The reference conv_only (deepq's trunk): NatureCNN's convolutions,
    flattened, no Dense (f32[N, 3136] at 84x84)."""

    def __init__(self, in_channels: int = 4, height: int = 84,
                 width: int = 84, dtype=torch.float32):
        super().__init__(NATURE_CONVS, in_channels, height, width, None,
                         dtype)


class Im2ColCNN(nn.Module):
    """JAX's cnn_im2col: NatureCNN with its first conv written as an
    im2col, the stride-4 8x8 windows laid out from pairs of adjacent
    4-blocks in JAX's (kh, kw, c) window order, times ``conv1`` (a Linear
    of 8 * 8 * c inputs: flax's ``conv1_kernel`` transposed), then the
    two other convs (``conv_0``, ``conv_1``, flax's ``Conv_0``,
    ``Conv_1``) and the Dense of 512. Its function is NatureCNN's up to
    the order of the first contraction; its params are not a cnn
    checkpoint's. Frames whose sides are multiples of 4."""

    def __init__(self, in_channels: int = 4, height: int = 84,
                 width: int = 84, dtype=torch.float32):
        super().__init__()
        self.dtype = as_dtype(dtype)
        if height % 4 or width % 4:
            raise ValueError(f"cnn_im2col: {height}x{width} is not made of "
                             "4x4 blocks")
        self.conv1 = nn.Linear(8 * 8 * in_channels, 32)
        h, w = height // 4 - 1, width // 4 - 1
        self.conv_0 = nn.Conv2d(32, 64, 4, stride=2)
        h, w = _conv_out(h, 4, 2), _conv_out(w, 4, 2)
        self.conv_1 = nn.Conv2d(64, 64, 3, stride=1)
        h, w = _conv_out(h, 3, 1), _conv_out(w, 3, 1)
        self.fc = nn.Linear(64 * h * w, 512)
        self.latent = 512

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_obs(x, self.dtype)                  # NHWC
        n, h, w, c = x.shape
        a = x.reshape(n, h // 4, 4, w // 4, 4, c)
        b = torch.cat([a[:, :-1], a[:, 1:]], dim=2)   # [n, h', 8, w/4, 4, c]
        p = torch.cat([b[:, :, :, :-1], b[:, :, :, 1:]], dim=4)
        hb, wb = h // 4 - 1, w // 4 - 1
        p = p.permute(0, 1, 3, 2, 4, 5).reshape(n, hb, wb, 8 * 8 * c)
        x = torch.relu(_apply(self.conv1, p)).permute(0, 3, 1, 2)
        x = torch.relu(_apply(self.conv_0, x))
        x = torch.relu(_apply(self.conv_1, x))
        return torch.relu(_apply(self.fc, x.flatten(1))).to(torch.float32)


class CoutPadConv(nn.Conv2d):
    """A VALID convolution whose output channels are padded with zero
    kernels to ``lanes`` and sliced back before the bias, as JAX's
    cnn_coutpad computes each conv: the same values as the plain conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, lanes: int = 128):
        super().__init__(in_channels, out_channels, kernel, stride=stride)
        self.lanes = lanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, self.lanes - w.shape[0]))
        y = F.conv2d(x, w, None, self.stride)[:, :self.out_channels]
        return y + self.bias.to(x.dtype)[:, None, None]


class CoutPadCNN(nn.Module):
    """JAX's cnn_coutpad: NatureCNN with every conv's output channels
    padded to 128 and sliced back (``c1``, ``c2``, ``c3``: flax's
    ``c<i>_kernel`` HWIO and ``c<i>_bias``), then the Dense of 512."""

    def __init__(self, in_channels: int = 4, height: int = 84,
                 width: int = 84, dtype=torch.float32):
        super().__init__()
        self.dtype = as_dtype(dtype)
        h, w, c = height, width, in_channels
        for i, (ch, k, s) in enumerate(NATURE_CONVS):
            setattr(self, f"c{i + 1}", CoutPadConv(c, ch, k, s))
            h, w, c = _conv_out(h, k, s), _conv_out(w, k, s), ch
        self.fc = nn.Linear(c * h * w, 512)
        self.latent = 512

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_obs(x.permute(0, 3, 1, 2), self.dtype)
        for i in range(1, 4):
            x = torch.relu(getattr(self, f"c{i}")(x))
        return torch.relu(_apply(self.fc, x.flatten(1))).to(torch.float32)


class MLP(nn.Module):
    """The reference models.py mlp: flatten, then ``num_layers`` Dense
    layers of ``num_hidden`` units with tanh."""

    def __init__(self, in_features: int, num_layers: int = 2,
                 num_hidden: int = 64, dtype=torch.float32):
        super().__init__()
        self.dtype = as_dtype(dtype)
        sizes = [in_features] + [num_hidden] * num_layers
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.latent = sizes[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm_obs(x, self.dtype).flatten(1)
        for layer in self.layers:
            x = torch.tanh(_apply(layer, x))
        return x.to(torch.float32)


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``: gates i, f, g, o; the input kernels
    carry no bias, the hidden ones do. carry (c, h) -> (c', h'), with
    c' = sigmoid(f) c + sigmoid(i) tanh(g) and h' = sigmoid(o) tanh(c')."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.ih = nn.Linear(in_features, 4 * hidden, bias=False)
        self.hh = nn.Linear(hidden, 4 * hidden)

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        i, f, g, o = (self.hh(h) + self.ih(x)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


def _keep(done: torch.Tensor) -> torch.Tensor:
    """1 - done as f32 with a trailing unit axis: the carry's multiplier."""
    return (1.0 - done.to(torch.float32))[..., None]


class LSTMTrunk(nn.Module):
    """The reference lstm / cnn_lstm / cnn_lnlstm: a base trunk, with
    ``layer_norm`` a LayerNorm (flax's: epsilon 1e-6) on its latent, then
    an LSTM cell of ``nlstm`` units. The caller threads the carry: the
    carry of every env whose ``done`` is set is zeroed before the cell."""

    def __init__(self, base: nn.Module, nlstm: int = 128,
                 layer_norm: bool = False):
        super().__init__()
        self.base = base
        self.nlstm = nlstm
        if layer_norm:
            self.norm = nn.LayerNorm(base.latent, eps=1e-6)
        self.cell = LSTMCell(base.latent, nlstm)
        self.latent = nlstm

    def initial_carry(self, n: int):
        """(c, h), zeros f32[n, nlstm] on the trunk's device."""
        dev = self.cell.hh.weight.device
        return (torch.zeros(n, self.nlstm, device=dev),
                torch.zeros(n, self.nlstm, device=dev))

    def forward(self, x: torch.Tensor, carry, done: torch.Tensor):
        latent = self.base(x)
        if hasattr(self, "norm"):
            latent = self.norm(latent)
        return self._cell(carry, latent, _keep(done))

    def _cell(self, carry, latent, keep):
        """One step from the carry times ``keep`` (1 - done, [N, 1])."""
        carry = self.cell(tuple(c * keep for c in carry), latent)
        return carry[1], carry

    def unroll(self, x: torch.Tensor, carry, dones: torch.Tensor):
        """forward over a time axis: x [T, B, ...], dones [T, B] ->
        (latents [T, B, nlstm], last carry). The base trunk (and the
        LayerNorm) runs once over all T * B rows; only the cell loops
        over time."""
        t, b = dones.shape
        latent = self.base(x.reshape((t * b,) + tuple(x.shape[2:])))
        if hasattr(self, "norm"):
            latent = self.norm(latent)
        latent = latent.reshape(t, b, -1)
        keep = _keep(dones)
        outs = []
        for i in range(t):
            out, carry = self._cell(carry, latent[i], keep[i])
            outs.append(out)
        return torch.stack(outs), carry


class CNNLSTMCarry:
    """Marker: recurrent trunks return (latent, new_carry)."""


#: name -> factory(obs_shape, **network_kwargs) -> trunk module
NETWORKS: dict = {}


def register(name: str):
    """Decorator: add a trunk factory to the registry under ``name``."""
    def deco(fn):
        NETWORKS[name] = fn
        return fn
    return deco


def _hwc(obs_shape):
    h, w, c = obs_shape
    return c, h, w


@register("cnn")
def cnn(obs_shape, **kwargs):
    return NatureCNN(*_hwc(obs_shape), **kwargs)


@register("nature_cnn")
def nature_cnn(obs_shape, **kwargs):
    return NatureCNN(*_hwc(obs_shape), **kwargs)


@register("cnn_small")
def cnn_small(obs_shape, **kwargs):
    return SmallCNN(*_hwc(obs_shape), **kwargs)


@register("cnn_im2col")
def cnn_im2col(obs_shape, **kwargs):
    return Im2ColCNN(*_hwc(obs_shape), **kwargs)


@register("cnn_coutpad")
def cnn_coutpad(obs_shape, **kwargs):
    return CoutPadCNN(*_hwc(obs_shape), **kwargs)


@register("conv_only")
def conv_only(obs_shape, **kwargs):
    return ConvOnly(*_hwc(obs_shape), **kwargs)


@register("mlp")
def mlp(obs_shape, **kwargs):
    return MLP(math.prod(obs_shape), **kwargs)


@register("cnn_lstm")
def cnn_lstm(obs_shape, nlstm: int = 128, **kwargs):
    return LSTMTrunk(cnn(obs_shape, **kwargs), nlstm)


@register("cnn_lnlstm")
def cnn_lnlstm(obs_shape, nlstm: int = 128, **kwargs):
    return LSTMTrunk(cnn(obs_shape, **kwargs), nlstm, layer_norm=True)


@register("lstm")
def lstm(obs_shape, nlstm: int = 128, **kwargs):
    return LSTMTrunk(mlp(obs_shape, **kwargs), nlstm)


RECURRENT_NETWORKS = ("lstm", "cnn_lstm", "cnn_lnlstm")


def network_factory(name: str):
    """factory(obs_shape, **network_kwargs) -> trunk module with a
    ``latent`` width."""
    try:
        return NETWORKS[name]
    except KeyError:
        raise ValueError(
            f"unknown network {name!r}; the port has "
            f"{sorted(NETWORKS)}") from None


def get_network_builder(name):
    """The reference's name for ``network_factory``; a callable passes
    through as the factory itself."""
    return name if callable(name) else network_factory(name)


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
    and nn.Dense: lecun_normal kernels, zero biases; an LSTM cell as flax
    initialises OptimizedLSTMCell, gate by gate: lecun_normal input
    kernels, orthogonal hidden kernels, zero biases; a LayerNorm with unit
    scale and zero bias."""
    cells = [m for m in trunk.modules() if isinstance(m, LSTMCell)]
    in_cells = {id(lin) for c in cells for lin in (c.ih, c.hh)}
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)) and id(m) not in in_cells:
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        for c in cells:
            hidden = c.hh.weight.shape[1]
            for g in range(4):
                rows = slice(g * hidden, (g + 1) * hidden)
                lecun_normal_(c.ih.weight[rows], c.ih.weight.shape[1],
                              generator)
                nn.init.orthogonal_(c.hh.weight[rows], generator=generator)
            nn.init.zeros_(c.hh.bias)

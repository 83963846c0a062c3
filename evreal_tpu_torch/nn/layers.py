"""NN layers (``evreal_tpu/nn/layers.py``), NCHW, eval mode.

Parameter paths are the reference's torch module paths (EVREAL
model/submodules.py), so a converted checkpoint's keys load directly:
ConvLayer / UpsampleConvLayer / TransposedConvLayer / ResidualBlock and
the norm variants they use (BatchNorm and tracked InstanceNorm use running
statistics; the residual block's InstanceNorm uses instance statistics).

Convolutions are ``nn.Conv2d`` with OIHW weights. Its ``padding='same'``
is the convention the JAX package's ``conv2d`` copies: an even kernel pads
the extra element on the bottom/right. Linear layers and LayerNorm are
torch's ``nn.Linear`` and ``nn.LayerNorm`` (eps 1e-5), pixel shuffle is
``F.pixel_shuffle``: each is the operation the JAX package reimplements.
"""

import torch
import torch.nn.functional as F
from torch import nn

_EPS_NORM = 1e-5

ACTIVATIONS = {
    None: None,
    "": None,
    "none": None,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def activation_fn(name):
    """Activation by name; like the reference (``getattr(torch, name)``,
    unet.py:34), any torch function name resolves, e.g. 'exp'."""
    if callable(name):
        return name
    if name in ACTIVATIONS:
        return ACTIVATIONS[name]
    fn = getattr(torch, name, None)
    if fn is None or not callable(fn):
        raise ValueError(f"unknown activation {name!r} (not in "
                         f"{sorted(k for k in ACTIVATIONS if k)} or torch)")
    return fn


class RunningNorm2d(nn.Module):
    """Normalization by running statistics: BatchNorm2d in eval mode
    (``affine=True``) or InstanceNorm2d(track_running_stats=True) in eval
    mode (``affine=False``, torch's default for it)."""

    def __init__(self, channels, affine=True):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=_EPS_NORM)


def make_norm(norm, channels):
    """ConvLayer's norm module: 'BN' or tracked 'IN', else None."""
    if norm == "BN":
        return RunningNorm2d(channels, affine=True)
    if norm == "IN":
        return RunningNorm2d(channels, affine=False)
    return None


def instance_norm(x):
    """InstanceNorm2d(track_running_stats=False): per-sample, per-channel
    statistics over H, W even in eval mode; no affine."""
    return F.instance_norm(x, eps=_EPS_NORM)


def resize_bilinear(x, out_h, out_w):
    """``jax.image.resize(method='bilinear', antialias=False)``: half-pixel
    centers, no antialiasing on downsampling. The output size is given,
    not a scale factor, so the source coordinate is ``(i + 0.5) * in / out
    - 0.5`` as there."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_nearest(x, out_h, out_w):
    """Nearest resize by the JAX package's index rule, ``floor(arange(out)
    * (in / out))`` in f32; equal sizes return ``x``. (``F.interpolate``'s
    nearest mode computes its scale differently.)"""
    h, w = x.shape[-2:]
    if (out_h, out_w) == (h, w):
        return x

    def index(n_in, n_out):  # made on x's device: no host copy per call
        pos = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor(pos * (n_in / n_out)).to(torch.int64)

    return x[..., index(h, out_h), :][..., index(w, out_w)]


def unfold(x, kernel_size, padding=0):
    """``F.unfold`` kept spatial: (N, C, H, W) -> (N, C * k * k, H', W')
    patches in torch's (C, kh, kw) order (stride 1)."""
    n = x.shape[0]
    h = x.shape[2] + 2 * padding - kernel_size + 1
    w = x.shape[3] + 2 * padding - kernel_size + 1
    return F.unfold(x, kernel_size, padding=padding).view(n, -1, h, w)


class ConvLayer(nn.Module):
    """ConvLayer (submodules.py:8-35): conv -> norm -> activation."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, activation="relu", norm=None):
        super().__init__()
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                stride=stride, padding=padding)
        self.norm_layer = make_norm(norm, out_channels)
        self.activation = activation_fn(activation)

    def forward(self, x):
        out = self.conv2d(x)
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        return self.activation(out) if self.activation is not None else out


class UpsampleConvLayer(nn.Module):
    """UpsampleConvLayer (submodules.py:69-97): 2x bilinear (half-pixel
    centers) then conv."""

    def __init__(self, in_channels, out_channels, kernel_size, padding=0,
                 activation="relu", norm=None):
        super().__init__()
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                padding=padding)
        self.norm_layer = make_norm(norm, out_channels)
        self.activation = activation_fn(activation)

    def forward(self, x):
        up = F.interpolate(x, scale_factor=2, mode="bilinear",
                           align_corners=False)
        out = self.conv2d(up)
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        return self.activation(out) if self.activation is not None else out


class TransposedConvLayer(nn.Module):
    """TransposedConvLayer (submodules.py:38-66): stride-2 deconv,
    output_padding 1."""

    def __init__(self, in_channels, out_channels, kernel_size, padding=0,
                 activation="relu", norm=None):
        super().__init__()
        self.transposed_conv2d = nn.ConvTranspose2d(
            in_channels, out_channels, kernel_size, stride=2,
            padding=padding, output_padding=1)
        self.norm_layer = make_norm(norm, out_channels)
        self.activation = activation_fn(activation)

    def forward(self, x):
        out = self.transposed_conv2d(x)
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        return self.activation(out) if self.activation is not None else out


class ResidualBlock(nn.Module):
    """ResidualBlock (submodules.py:152-184); norm='IN' here is untracked
    InstanceNorm (instance statistics at eval)."""

    def __init__(self, channels, norm=None):
        super().__init__()
        self.norm = norm
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        if norm == "BN":
            self.bn1 = RunningNorm2d(channels)
            self.bn2 = RunningNorm2d(channels)

    def _norm(self, x, which):
        if self.norm == "BN":
            return getattr(self, which)(x)
        if self.norm == "IN":
            return instance_norm(x)
        return x

    def forward(self, x):
        out = torch.relu(self._norm(self.conv1(x), "bn1"))
        out = self._norm(self.conv2(out), "bn2")
        return torch.relu(out + x)

"""NN layers of the main path (``evreal_tpu/nn/layers.py``), NCHW, eval mode.

Parameter paths are the reference's torch module paths (EVREAL
model/submodules.py), so a converted checkpoint's keys load directly:
ConvLayer / UpsampleConvLayer / TransposedConvLayer / ResidualBlock and
the norm variants they use (BatchNorm and tracked InstanceNorm use running
statistics; the residual block's InstanceNorm uses instance statistics).

Convolutions are ``nn.Conv2d`` with OIHW weights. Its ``padding='same'``
is the convention the JAX package's ``conv2d`` copies: an even kernel pads
the extra element on the bottom/right.
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

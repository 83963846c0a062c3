"""HyperE2VID's dynamic decoder (``evreal_tpu/models/hyper.py``; reference
model/hyper/hyper_dynamic.py and model/hyper/fourier_bessel.py).

The first decoder of the UNet becomes a ``DynamicUpsampleLayer``: a
context of the event tensor and the previous reconstruction, resized to a
quarter, generates per-pixel filter atoms over fixed multiscale
Fourier-Bessel bases, and a dynamic convolution composes them with learned
coefficients. The Bessel-root table is regenerated from
``scipy.special.jn_zeros`` (orders <= 15 and small roots are all the
reference's own filtering keeps).

The reference's widths inside the layer (the context's channels and
kernel, the atom network's hidden width and kernel, the number of bases
per scale) are not recorded in this repository; the defaults here are an
assumption and ``DynamicUpsampleLayer.shapes_of`` reads the real ones from
a checkpoint's arrays.
"""

import functools

import numpy as np
import torch
from torch import nn

from evreal_tpu_torch.nn.layers import (
    RunningNorm2d,
    activation_fn,
    resize_bilinear,
    unfold,
)

NUM_ATOMS = 6  # evreal_tpu/models/hyper.py: num_atoms=6 at every call


@functools.lru_cache(maxsize=None)
def _bessel_table(kmax=15, qmax=32):
    from scipy.special import jn_zeros

    rows = []
    for k in range(kmax + 1):
        zeros = jn_zeros(k, qmax + 1)
        for q in range(1, qmax + 1):
            rows.append((float(k), float(q), zeros[q - 1], zeros[q]))
    return np.array(rows)


def calculate_fb_bases(l1):
    """Fourier-Bessel bases on a (2 * l1 + 1)^2 grid, reference semantics:
    ((2 * l1 + 1)^2, num_bases) float64."""
    from scipy import special

    max_k = (2 * l1 + 1) ** 2 - 1
    l = l1 + 1
    r = l1 + 0.5
    truncate_freq_factor = 2.0 if l1 < 2 else 1.5

    xx, yy = np.meshgrid(range(-l, l + 1), range(-l, l + 1))
    xx = xx / r
    yy = yy / r
    ugrid = np.concatenate([yy.reshape(-1, 1), xx.reshape(-1, 1)], 1)
    tgrid = np.arctan2(ugrid[:, 1], ugrid[:, 0])
    rgrid = np.sqrt(ugrid[:, 0] ** 2 + ugrid[:, 1] ** 2)

    table = _bessel_table()
    b = table[(table[:, 0] <= 15)
              & (table[:, 3] <= np.pi * r * truncate_freq_factor)]
    idx = np.argsort(b[:, 2])
    ang_freqs = b[idx, 0]
    r_ns = b[idx, 2]

    psi = []
    for i in range(b.shape[0]):
        ki = ang_freqs[i]
        phi = special.jv(ki, rgrid * r_ns[i]) / np.abs(special.jv(ki + 1,
                                                                 r_ns[i]))
        phi[rgrid >= 1] = 0
        if ki == 0:
            psi.append(phi)
        else:
            psi.append(phi * np.cos(ki * tgrid) * np.sqrt(2))
            psi.append(phi * np.sin(ki * tgrid) * np.sqrt(2))

    psi = np.array(psi)[:max_k]
    num_bases = psi.shape[0]
    p = psi.reshape(num_bases, 2 * l + 1, 2 * l + 1).transpose(1, 2, 0)
    p = p[1:-1, 1:-1, :].reshape((2 * l1 + 1) ** 2, num_bases)
    c = np.sqrt(np.mean(np.sum(p ** 2, 0)))
    return p / c


def bases_list(ks, num_bases):
    """Multiscale FB bases, (num_scales * num_bases, ks * ks) f32: for each
    scale s (kernel 2 s + 3) its first ``num_bases`` bases, zero-padded to
    ks x ks (reference fourier_bessel.bases_list)."""
    len_list = ks // 2
    out = []
    for i in range(len_list):
        ksize = (i + 1) * 2 + 1
        normed = calculate_fb_bases(i + 1).T.reshape(-1, ksize, ksize)
        normed = normed.astype(np.float32)[:num_bases]
        pad = len_list - (i + 1)
        padded = np.pad(normed, ((0, 0), (pad, pad), (pad, pad)))
        out.append(padded.reshape(num_bases, ks * ks))
    return np.concatenate(out, 0)


def _same_conv(cin, cout, k):
    return nn.Conv2d(cin, cout, k, padding="same")


class ConvolutionalContextFusion(nn.Module):
    """hyper_dynamic.py:7-23: cat(events, previous image) -> bilinear
    resize to a quarter -> conv."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 downsample_factor=4):
        super().__init__()
        self.conv = _same_conv(in_channels, out_channels, kernel_size)
        self.downsample_factor = downsample_factor

    def forward(self, ev_tensor, prev_recs):
        ctx = torch.cat([ev_tensor, prev_recs], dim=1)
        h, w = ctx.shape[-2:]
        f = self.downsample_factor
        return self.conv(resize_bilinear(ctx, h // f, w // f))


class DynamicAtomGeneration(nn.Module):
    """hyper_dynamic.py:26-57: conv -> BN -> tanh -> conv -> BN -> tanh
    gives per-pixel coefficients (channel m * K + k) over the K bases;
    returns atoms (N, num_atoms, ks * ks, H, W)."""

    def __init__(self, in_channels, hidden, kernel_size, num_bases,
                 filter_size, num_atoms=NUM_ATOMS):
        super().__init__()
        bases = bases_list(filter_size, num_bases)
        self.num_atoms = num_atoms
        self.bases_net = nn.Sequential(
            _same_conv(in_channels, hidden, kernel_size),
            RunningNorm2d(hidden), nn.Tanh(),
            _same_conv(hidden, num_atoms * bases.shape[0], kernel_size),
            RunningNorm2d(num_atoms * bases.shape[0]), nn.Tanh())
        self.register_buffer("bases", torch.from_numpy(bases))

    def forward(self, context):
        coeff = self.bases_net(context)
        n, _, h, w = coeff.shape
        coeff = coeff.view(n, self.num_atoms, self.bases.shape[0], h, w)
        return torch.einsum("nmkhw,kl->nmlhw", coeff, self.bases)


class DynamicConv(nn.Module):
    """hyper_dynamic.py:60-92: unfold the input into ks x ks patches,
    weight them by the atoms (intermediate channel c * num_atoms + m), then
    a 1x1 conv with the compositional coefficients, plus the bias."""

    def __init__(self, in_channels, out_channels, kernel_size, padding,
                 num_atoms=NUM_ATOMS):
        super().__init__()
        self.kernel_size, self.padding = kernel_size, padding
        self.compositional_coefficients = nn.Parameter(torch.empty(
            out_channels, in_channels * num_atoms, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.compositional_coefficients,
                                 a=5 ** 0.5)

    def forward(self, x, atoms):
        n, c, h, w = x.shape
        patches = unfold(x, self.kernel_size, self.padding)
        patches = patches.view(n, c, self.kernel_size ** 2, h, w)
        inter = torch.einsum("nmlhw,nclhw->ncmhw", atoms, patches)
        inter = inter.reshape(n, -1, h, w)
        return torch.nn.functional.conv2d(
            inter, self.compositional_coefficients, self.bias)


class DynamicUpsampleLayer(nn.Module):
    """submodules.py:100-127: 2x bilinear upsample, then the dynamic conv
    whose atoms come from the event tensor and the previous image."""

    def __init__(self, in_channels, out_channels, kernel_size, padding,
                 num_bins, activation="relu", context_channels=32,
                 context_kernel=3, atom_hidden=64, atom_kernel=3,
                 num_bases=6):
        super().__init__()
        self.context_fusion = ConvolutionalContextFusion(
            num_bins + 1, context_channels, context_kernel)
        self.dynamic_atom_generation = DynamicAtomGeneration(
            context_channels, atom_hidden, atom_kernel, num_bases,
            kernel_size)
        self.dynamic_conv = DynamicConv(in_channels, out_channels,
                                        kernel_size, padding)
        self.activation = activation_fn(activation)

    @staticmethod
    def shapes_of(state_dict, prefix):
        """The layer's widths as a checkpoint's arrays (torch layout) under
        ``prefix`` give them."""
        ctx = state_dict[prefix + "context_fusion.conv.weight"].shape
        atom = state_dict[prefix + "dynamic_atom_generation.bases_net.0."
                          "weight"].shape
        bases = state_dict[prefix + "dynamic_atom_generation.bases"].shape
        return dict(context_channels=int(ctx[0]), context_kernel=int(ctx[2]),
                    atom_hidden=int(atom[0]), atom_kernel=int(atom[2]),
                    num_bases=int(bases[0]) // (int(bases[1] ** 0.5) // 2))

    def forward(self, x, ev_tensor, prev_recs):
        h, w = x.shape[-2:]
        up = resize_bilinear(x, 2 * h, 2 * w)
        ctx = self.context_fusion(ev_tensor, prev_recs)
        out = self.dynamic_conv(up, self.dynamic_atom_generation(ctx))
        return self.activation(out) if self.activation is not None else out

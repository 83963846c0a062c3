"""E2VID family: recurrent UNet (``evreal_tpu/models/unet.py``; reference
model/unet.py + model/model.py).

Covers E2VID, E2VID+ and SSL-E2VID. HyperE2VID's dynamic decoder
(``use_dynamic_decoder=True``) is not ported yet. The state is explicit:
``{"cells": [...], "prev_recs": (N, C, H, W)}``.
"""

import torch
from torch import nn

from evreal_tpu_torch.nn.cells import RecurrentConvLayer, zero_state_fn
from evreal_tpu_torch.nn.layers import (
    ConvLayer,
    ResidualBlock,
    TransposedConvLayer,
    UpsampleConvLayer,
    activation_fn,
)


def _skip(kind, x, y):
    if kind == "sum":
        return x + y
    if kind == "concat":
        return torch.cat([x, y], dim=1)
    raise ValueError(f"unknown skip type {kind}")


class UNetRecurrentCore(nn.Module):
    """UNetRecurrent (unet.py:85-143): head, recurrent encoders, residual
    blocks, upsampling decoders with skips, 1x1 prediction."""

    def __init__(self, base_num_channels, num_encoders, num_residual_blocks,
                 num_bins, skip_type="sum", norm=None, use_upsample_conv=True,
                 recurrent_block_type=None, kernel_size=5,
                 channel_multiplier=2, use_dynamic_decoder=False,
                 final_activation="none", num_output_channels=1,
                 **unexpected):
        super().__init__()
        if unexpected:
            # the reference's BaseUNet raises TypeError on unknown
            # unet_kwargs: a typo'd key must not fall back to a default
            raise TypeError("UNetRecurrent: unexpected unet_kwargs "
                            f"{sorted(unexpected)}")
        if use_dynamic_decoder:
            raise NotImplementedError(
                "HyperE2VID's dynamic decoder (use_dynamic_decoder=True) is "
                "not ported yet: ROADMAP.md, Queue 1 item 9")
        self.base = int(base_num_channels)
        self.num_encoders = int(num_encoders)
        self.num_residual_blocks = int(num_residual_blocks)
        self.num_bins = int(num_bins)
        self.skip_type = skip_type
        self.norm = None if norm in (None, "none") else str(norm)
        self.cell = recurrent_block_type or "convlstm"
        self.kernel_size = int(kernel_size)
        self.num_output_channels = int(num_output_channels)
        self.final_activation = activation_fn(final_activation)

        k, pad = self.kernel_size, self.kernel_size // 2
        enc_in = [int(self.base * channel_multiplier ** i)
                  for i in range(self.num_encoders)]
        enc_out = [int(self.base * channel_multiplier ** (i + 1))
                   for i in range(self.num_encoders)]
        self.encoder_output_sizes = enc_out
        cat = 2 if skip_type == "concat" else 1
        self.head = ConvLayer(self.num_bins, self.base, k, stride=1,
                              padding=pad)
        self.encoders = nn.ModuleList(
            RecurrentConvLayer(enc_in[i], enc_out[i], k, stride=2,
                               padding=pad, recurrent_block_type=self.cell,
                               norm=self.norm)
            for i in range(self.num_encoders))
        self.resblocks = nn.ModuleList(
            ResidualBlock(enc_out[-1], norm=self.norm)
            for _ in range(self.num_residual_blocks))
        dec = UpsampleConvLayer if use_upsample_conv else TransposedConvLayer
        self.decoders = nn.ModuleList(
            dec(cat * enc_out[-1 - i], enc_in[-1 - i], k, padding=pad,
                norm=self.norm)
            for i in range(self.num_encoders))
        self.pred = ConvLayer(cat * self.base, self.num_output_channels, 1,
                              activation=None, norm=self.norm)

    def init_cell_states(self, batch, h, w, device=None, dtype=torch.float32):
        zero = zero_state_fn(self.cell)
        states = []
        for size in self.encoder_output_sizes:
            h, w = (h + 1) // 2, (w + 1) // 2
            states.append(zero(batch, h, w, size, device, dtype))
        return states

    def forward(self, x, cell_states):
        x = self.head(x)
        head = x
        blocks, new_states = [], []
        for enc, st in zip(self.encoders, cell_states):
            x, st = enc(x, st)
            blocks.append(x)
            new_states.append(st)
        for res in self.resblocks:
            x = res(x)
        for i, dec in enumerate(self.decoders):
            x = dec(_skip(self.skip_type, x,
                          blocks[self.num_encoders - i - 1]))
        img = self.pred(_skip(self.skip_type, x, head))
        if self.final_activation is not None:
            img = self.final_activation(img)
        return img, new_states


class E2VIDRecurrent(nn.Module):
    """Reference model/model.py:108-144 wrapper (carries prev_recs)."""

    def __init__(self, unet_kwargs=None, **kwargs):
        super().__init__()
        if unet_kwargs:
            kwargs = {**dict(unet_kwargs), **kwargs}  # explicit kwargs win
        self.unetrecurrent = UNetRecurrentCore(**kwargs)
        self.num_bins = self.unetrecurrent.num_bins
        self.num_encoders = self.unetrecurrent.num_encoders

    def init_state(self, batch, h, w, device=None, dtype=torch.float32):
        core = self.unetrecurrent
        # prev_recs holds what forward() stores: the 3-channel config splits
        # image/flow and keeps the 1-channel image
        img_ch = (1 if core.num_output_channels == 3
                  else core.num_output_channels)
        return {
            "cells": core.init_cell_states(batch, h, w, device, dtype),
            "prev_recs": torch.zeros((batch, img_ch, h, w), device=device,
                                     dtype=dtype),
        }

    def forward(self, voxel, state):
        """voxel (N, num_bins, H, W) -> ({"image": (N, 1, H, W)}, state)."""
        img, cells = self.unetrecurrent(voxel, state["cells"])
        out = {"image": img}
        if self.unetrecurrent.num_output_channels == 3:
            out = {"image": img[:, 0:1], "flow": img[:, 1:3]}
        return out, {"cells": cells, "prev_recs": out["image"].detach()}

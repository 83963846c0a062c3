"""E2VID family: recurrent UNet (``evreal_tpu/models/unet.py``; reference
model/unet.py + model/model.py).

Covers E2VID, E2VID+, SSL-E2VID (plain decoders) and HyperE2VID
(``use_dynamic_decoder=True``: the first decoder is a
``DynamicUpsampleLayer`` fed by the event tensor and the previous
reconstruction, reference unet.py:60-64, 129-134), and ``FlowNet``. The
state is explicit: ``{"cells": [...], "prev_recs": (N, C, H, W)}``.
"""

import torch
from torch import nn

from evreal_tpu_torch.models.hyper import DynamicUpsampleLayer
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
    blocks, upsampling decoders with skips, 1x1 prediction.
    ``dynamic_shapes`` sets the dynamic decoder's inner widths
    (``DynamicUpsampleLayer.shapes_of``; None: the defaults). It is not a
    reference kwarg and is positional only, so no unet_kwargs can set
    it."""

    def __init__(self, dynamic_shapes, /, base_num_channels, num_encoders,
                 num_residual_blocks, num_bins, skip_type="sum", norm=None,
                 use_upsample_conv=True, recurrent_block_type=None,
                 kernel_size=5, channel_multiplier=2,
                 use_dynamic_decoder=False, final_activation="none",
                 num_output_channels=1, **unexpected):
        super().__init__()
        if unexpected:
            # the reference's BaseUNet raises TypeError on unknown
            # unet_kwargs: a typo'd key must not fall back to a default
            raise TypeError("UNetRecurrent: unexpected unet_kwargs "
                            f"{sorted(unexpected)}")
        self.use_dynamic_decoder = bool(use_dynamic_decoder)
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
            DynamicUpsampleLayer(cat * enc_out[-1], enc_in[-1], k, pad,
                                 self.num_bins, **(dynamic_shapes or {}))
            if i == 0 and self.use_dynamic_decoder else
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

    def forward(self, x, cell_states, prev_recs):
        ev_tensor = x
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
            inp = _skip(self.skip_type, x, blocks[self.num_encoders - i - 1])
            if i == 0 and self.use_dynamic_decoder:
                x = dec(inp, ev_tensor, prev_recs)
            else:
                x = dec(inp)
        img = self.pred(_skip(self.skip_type, x, head))
        if self.final_activation is not None:
            img = self.final_activation(img)
        return img, new_states


class E2VIDRecurrent(nn.Module):
    """Reference model/model.py:108-144 wrapper (carries prev_recs);
    ``kwargs`` are the unet_kwargs (``build_model`` unwraps them)."""

    PARAM_ROOT = "unetrecurrent"

    def __init__(self, dynamic_shapes=None, /, **kwargs):
        super().__init__()
        self.add_module(self.PARAM_ROOT,
                        UNetRecurrentCore(dynamic_shapes, **kwargs))
        self.num_bins = self.core.num_bins
        self.num_encoders = self.core.num_encoders

    @property
    def core(self):
        return getattr(self, self.PARAM_ROOT)

    @classmethod
    def shape_args(cls, state_dict):
        """The positional constructor argument that a checkpoint's arrays
        fix: the dynamic decoder's inner widths, where there is one."""
        prefix = cls.PARAM_ROOT + ".decoders.0."
        if prefix + "context_fusion.conv.weight" not in state_dict:
            return ()
        return (DynamicUpsampleLayer.shapes_of(state_dict, prefix),)

    def init_state(self, batch, h, w, device=None, dtype=torch.float32):
        core = self.core
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
        img, cells = self.core(voxel, state["cells"], state["prev_recs"])
        out = {"image": img}
        if self.core.num_output_channels == 3:
            out = {"image": img[:, 0:1], "flow": img[:, 1:3]}
        return out, {"cells": cells, "prev_recs": out["image"].detach()}


class FlowNet(E2VIDRecurrent):
    """Reference model/model.py:14-43 (exported, unused by eval): the
    same network under ``unetflow``; 3 output channels split into the
    image and a 2-channel flow."""

    PARAM_ROOT = "unetflow"

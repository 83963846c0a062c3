"""FireNet family (``evreal_tpu/models/firenet.py``).

* ``FireNet`` (reference model/model.py:147-190): head conv -> [ConvGRU ->
  ResidualBlock] x2 -> 1x1 pred. Used by the FireNet+ method (num_encoders
  forced to 0, reference eval.py:154-155).
* ``FireNetLegacy`` (``UNetFire``, reference model/legacy.py:32-187): a
  recurrent head, residual blocks of which the listed ones are recurrent,
  a 1x1 pred, all under ``net.``. Used by the FireNet method.

The state is a dict of the cells' hidden tensors, zero-initialized.
"""

import torch
from torch import nn

from evreal_tpu_torch.nn.cells import (
    ConvGRU,
    RecurrentConvLayer,
    RecurrentResidualLayer,
    conv_gru_zero_state,
    zero_state_fn,
)
from evreal_tpu_torch.nn.layers import ConvLayer, ResidualBlock


class FireNet(nn.Module):
    def __init__(self, num_bins=5, base_num_channels=16, kernel_size=3, **_):
        super().__init__()
        self.num_bins = int(num_bins)
        self.base = int(base_num_channels)
        self.kernel_size = int(kernel_size)
        self.num_encoders = 0  # forced for FireNet+ (eval.py:154-155)
        k, b = self.kernel_size, self.base
        self.head = ConvLayer(self.num_bins, b, k, padding=k // 2)
        self.G1 = ConvGRU(b, b, k)
        self.R1 = ResidualBlock(b)
        self.G2 = ConvGRU(b, b, k)
        self.R2 = ResidualBlock(b)
        self.pred = ConvLayer(b, 1, 1, activation=None)

    def init_state(self, batch, h, w, device=None, dtype=torch.float32):
        return {name: conv_gru_zero_state(batch, h, w, self.base, device,
                                          dtype)
                for name in ("G1", "G2")}

    def forward(self, voxel, state):
        x = self.head(voxel)
        x, g1 = self.G1(x, state["G1"])
        x = self.R1(x)
        x, g2 = self.G2(x, state["G2"])
        x = self.R2(x)
        return {"image": self.pred(x)}, {"G1": g1, "G2": g2}


class _UNetFire(nn.Module):
    """The legacy network (legacy.py:32-120): head, residual blocks, pred."""

    def __init__(self, num_bins, base, kernel_size, cell, norm,
                 num_residual_blocks, recurrent):
        super().__init__()
        self.head = RecurrentConvLayer(num_bins, base, kernel_size,
                                       padding=kernel_size // 2,
                                       recurrent_block_type=cell, norm=norm)
        self.resblocks = nn.ModuleList(
            RecurrentResidualLayer(base, recurrent_block_type=cell,
                                   norm=norm) if i in recurrent
            else ResidualBlock(base, norm=norm)
            for i in range(num_residual_blocks))
        self.pred = ConvLayer(base, 1, 1, activation=None)


class FireNetLegacy(nn.Module):
    """``FireNet_legacy``: ``kernel_size`` defaults to 5 (the reference
    wrapper's ``config.get('kernel_size', 5)``, legacy.py:152); a missing
    ``recurrent_blocks`` means block 0 is recurrent, an explicit ``{}``
    none, index -1 all. ``final_activation`` is accepted and unused, as in
    the reference; ``num_encoders`` only sets the crop's padding."""

    def __init__(self, num_bins=5, skip_type="sum", num_encoders=4,
                 base_num_channels=32, num_residual_blocks=2, norm=None,
                 kernel_size=5, recurrent_block_type="convgru",
                 recurrent_blocks=None, BN_momentum=0.1, **_):
        super().__init__()
        self.num_bins = int(num_bins)
        self.num_encoders = int(num_encoders)
        self.base = int(base_num_channels)
        self.num_residual_blocks = int(num_residual_blocks)
        self.cell = str(recurrent_block_type)
        if recurrent_blocks is None:
            recurrent_blocks = {"resblock": [0]}
        indices = list(recurrent_blocks.get("resblock", []))
        self.recurrent = [i for i in range(self.num_residual_blocks)
                          if i in indices or -1 in indices]
        self.net = _UNetFire(self.num_bins, self.base, int(kernel_size),
                             self.cell,
                             None if norm in (None, "none") else str(norm),
                             self.num_residual_blocks, self.recurrent)

    def init_state(self, batch, h, w, device=None, dtype=torch.float32):
        zero = zero_state_fn(self.cell)
        state = {"head": zero(batch, h, w, self.base, device, dtype)}
        for i in self.recurrent:
            state[f"resblock{i}"] = zero(batch, h, w, self.base, device,
                                         dtype)
        return state

    def forward(self, voxel, state):
        new_state = {}
        x, new_state["head"] = self.net.head(voxel, state["head"])
        for i, block in enumerate(self.net.resblocks):
            if i in self.recurrent:
                x, new_state[f"resblock{i}"] = block(
                    x, state[f"resblock{i}"])
            else:
                x = block(x)
        return {"image": self.net.pred(x)}, new_state

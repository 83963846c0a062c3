"""FireNet (``evreal_tpu/models/firenet.py``; reference model/model.py:147-190):
head conv -> [ConvGRU -> ResidualBlock] x2 -> 1x1 pred. Used by the
FireNet+ method (num_encoders forced to 0, reference eval.py:154-155).
The state is a dict of ConvGRU hidden tensors, zero-initialized."""

import torch
from torch import nn

from evreal_tpu_torch.nn.cells import ConvGRU, conv_gru_zero_state
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

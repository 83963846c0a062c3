"""Recurrent convolutional cells with explicit state
(``evreal_tpu/nn/cells.py``; reference submodules.py:130-313).

The reference caches state on the module; here, as in the JAX package,
state is passed in and returned, and a fresh state is zeros.
"""

import torch
from torch import nn

from evreal_tpu_torch.nn.layers import ConvLayer, ResidualBlock


def conv_lstm_zero_state(batch, h, w, hidden, device=None,
                         dtype=torch.float32):
    z = torch.zeros((batch, hidden, h, w), device=device, dtype=dtype)
    return (z, z)


def conv_gru_zero_state(batch, h, w, hidden, device=None,
                        dtype=torch.float32):
    return torch.zeros((batch, hidden, h, w), device=device, dtype=dtype)


def zero_state_fn(cell):
    return conv_lstm_zero_state if cell == "convlstm" else conv_gru_zero_state


class ConvLSTM(nn.Module):
    """ConvLSTM (submodules.py:187-245): one gate conv over
    cat(x, hidden), split into (input, remember, out, cell) gates."""

    def __init__(self, input_size, hidden_size, kernel_size=3):
        super().__init__()
        self.Gates = nn.Conv2d(input_size + hidden_size, 4 * hidden_size,
                               kernel_size, padding=kernel_size // 2)

    def forward(self, x, state):
        prev_hidden, prev_cell = state
        gates = self.Gates(torch.cat([x, prev_hidden], dim=1))
        i, f, o, g = gates.chunk(4, dim=1)
        cell = torch.sigmoid(f) * prev_cell + torch.sigmoid(i) * torch.tanh(g)
        hidden = torch.sigmoid(o) * torch.tanh(cell)
        return hidden, (hidden, cell)


class ConvGRU(nn.Module):
    """ConvGRU (submodules.py:248-287)."""

    def __init__(self, input_size, hidden_size, kernel_size=3):
        super().__init__()
        pad = kernel_size // 2
        cat = input_size + hidden_size
        self.reset_gate = nn.Conv2d(cat, hidden_size, kernel_size,
                                    padding=pad)
        self.update_gate = nn.Conv2d(cat, hidden_size, kernel_size,
                                     padding=pad)
        self.out_gate = nn.Conv2d(cat, hidden_size, kernel_size, padding=pad)

    def forward(self, x, prev):
        stacked = torch.cat([x, prev], dim=1)
        update = torch.sigmoid(self.update_gate(stacked))
        reset = torch.sigmoid(self.reset_gate(stacked))
        out = torch.tanh(self.out_gate(torch.cat([x, prev * reset], dim=1)))
        new = prev * (1 - update) + out * update
        return new, new


def make_cell(cell, channels):
    """The recurrent block of a layer; its gate kernel is always 3, as the
    reference hardcodes it (submodules.py:143)."""
    return (ConvLSTM if cell == "convlstm" else ConvGRU)(channels, channels,
                                                          3)


class RecurrentConvLayer(nn.Module):
    """RecurrentConvLayer (submodules.py:130-149): ConvLayer -> cell."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, recurrent_block_type="convlstm",
                 activation="relu", norm=None):
        super().__init__()
        self.conv = ConvLayer(in_channels, out_channels, kernel_size, stride,
                              padding, activation, norm)
        self.recurrent_block = make_cell(recurrent_block_type, out_channels)

    def forward(self, x, state):
        return self.recurrent_block(self.conv(x), state)


class RecurrentResidualLayer(nn.Module):
    """RecurrentResidualLayer (submodules.py:290-313): ResidualBlock ->
    cell."""

    def __init__(self, channels, recurrent_block_type="convlstm", norm=None):
        super().__init__()
        self.conv = ResidualBlock(channels, norm=norm)
        self.recurrent_block = make_cell(recurrent_block_type, channels)

    def forward(self, x, state):
        return self.recurrent_block(self.conv(x), state)

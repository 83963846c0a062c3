"""The two networks in plain PyTorch, with EVREAL's module paths (so a
reference checkpoint's ``state_dict`` loads as it is), eval mode, NCHW,
float32:

* ``E2VIDRecurrent`` (Rebecq et al., TPAMI 2019; EVREAL model/model.py,
  model/unet.py, model/submodules.py): a 5x5 head, three stride-2
  encoders each followed by a ConvLSTM, two residual blocks, three
  decoders (2x bilinear upsampling, half-pixel centres, then a 5x5
  convolution) with sum skips, a 1x1 prediction on the sum with the head,
  and the sigmoid EVREAL's eval.py forces on E2VID checkpoints;
* ``FireNet`` (Scheerlinck et al., WACV 2020; EVREAL model/model.py): a
  3x3 head, ConvGRU, residual block, ConvGRU, residual block, a 1x1
  prediction, no final activation.

``step(voxel, state)`` takes one window for every lane and returns the
image and the next state; the state starts at zeros (``init_state``).
``pad_crop`` is EVREAL's CropParameters: a centred zero pad to a multiple
of ``2 ** num_encoders`` and the crop back.
"""

import importlib
import math

import torch
import torch.nn.functional as F
from torch import nn


class ConvLayer(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, relu=True):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, k, stride=stride, padding=padding)
        self.relu = relu

    def forward(self, x):
        x = self.conv2d(x)
        return torch.relu(x) if self.relu else x


class UpsampleConvLayer(nn.Module):
    def __init__(self, cin, cout, k, padding):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, k, padding=padding)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        return torch.relu(self.conv2d(x))


class ResidualBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        out = torch.relu(self.conv1(x))
        return torch.relu(self.conv2(out) + x)


class ConvLSTM(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.Gates = nn.Conv2d(2 * c, 4 * c, 3, padding=1)

    def forward(self, x, state):
        hidden, cell = state
        gates = self.Gates(torch.cat([x, hidden], 1))
        in_gate, remember_gate, out_gate, cell_gate = gates.chunk(4, 1)
        cell = (torch.sigmoid(remember_gate) * cell
                + torch.sigmoid(in_gate) * torch.tanh(cell_gate))
        hidden = torch.sigmoid(out_gate) * torch.tanh(cell)
        return hidden, (hidden, cell)


class ConvGRU(nn.Module):
    def __init__(self, c, k):
        super().__init__()
        self.reset_gate = nn.Conv2d(2 * c, c, k, padding=k // 2)
        self.update_gate = nn.Conv2d(2 * c, c, k, padding=k // 2)
        self.out_gate = nn.Conv2d(2 * c, c, k, padding=k // 2)

    def forward(self, x, prev):
        both = torch.cat([x, prev], 1)
        update = torch.sigmoid(self.update_gate(both))
        reset = torch.sigmoid(self.reset_gate(both))
        out = torch.tanh(self.out_gate(torch.cat([x, prev * reset], 1)))
        new = prev * (1 - update) + out * update
        return new


class RecurrentConvLayer(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = ConvLayer(cin, cout, k, stride=2, padding=k // 2)
        self.recurrent_block = ConvLSTM(cout)

    def forward(self, x, state):
        return self.recurrent_block(self.conv(x), state)


class UNetRecurrent(nn.Module):
    def __init__(self, num_bins, base, k, num_encoders, num_res):
        super().__init__()
        ins = [base * 2 ** i for i in range(num_encoders)]
        outs = [base * 2 ** (i + 1) for i in range(num_encoders)]
        self.head = ConvLayer(num_bins, base, k, padding=k // 2)
        self.encoders = nn.ModuleList(RecurrentConvLayer(i, o, k)
                                      for i, o in zip(ins, outs))
        self.resblocks = nn.ModuleList(ResidualBlock(outs[-1])
                                       for _ in range(num_res))
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(outs[-1 - i], ins[-1 - i], k, k // 2)
            for i in range(num_encoders))
        self.pred = ConvLayer(base, 1, 1, relu=False)
        self.outs = outs


class E2VIDRecurrent(nn.Module):
    """EVREAL's E2VIDRecurrent over ``UNetRecurrent`` (sum skips, no norm,
    ConvLSTM, upsample-conv decoders) with a final sigmoid."""

    def __init__(self, num_bins=5, base_num_channels=32, kernel_size=5,
                 num_encoders=3, num_residual_blocks=2, **_):
        super().__init__()
        self.unetrecurrent = UNetRecurrent(num_bins, base_num_channels,
                                           kernel_size, num_encoders,
                                           num_residual_blocks)
        self.num_encoders = num_encoders

    def init_state(self, n, h, w, device):
        states = []
        for c in self.unetrecurrent.outs:
            h, w = (h + 1) // 2, (w + 1) // 2
            z = torch.zeros((n, c, h, w), device=device)
            states.append((z, z))
        return states

    def step(self, x, state):
        u = self.unetrecurrent
        x = u.head(x)
        head = x
        blocks, new = [], []
        for enc, st in zip(u.encoders, state):
            x, st = enc(x, st)
            blocks.append(x)
            new.append(st)
        for res in u.resblocks:
            x = res(x)
        for i, dec in enumerate(u.decoders):
            x = dec(x + blocks[-1 - i])
        return torch.sigmoid(u.pred(x + head)), new


class FireNet(nn.Module):
    def __init__(self, num_bins=5, base_num_channels=16, kernel_size=3, **_):
        super().__init__()
        b, k = base_num_channels, kernel_size
        self.head = ConvLayer(num_bins, b, k, padding=k // 2)
        self.G1 = ConvGRU(b, k)
        self.R1 = ResidualBlock(b)
        self.G2 = ConvGRU(b, k)
        self.R2 = ResidualBlock(b)
        self.pred = ConvLayer(b, 1, 1, relu=False)
        self.base = b
        self.num_encoders = 0

    def init_state(self, n, h, w, device):
        z = torch.zeros((n, self.base, h, w), device=device)
        return [z, z]

    def step(self, x, state):
        x = self.head(x)
        g1 = self.G1(x, state[0])
        x = self.R1(g1)
        g2 = self.G2(x, state[1])
        x = self.R2(g2)
        return self.pred(x), [g1, g2]


# the settings these networks hard-code (EVREAL's E2VID family and FireNet)
FIXED = {"recurrent_block_type": ("convlstm",), "skip_type": ("sum",),
         "norm": (None, "none"), "use_upsample_conv": (True,)}


def build(config):
    """The configuration's network (``config["class"]`` at
    ``config["kwargs"]``), uninitialized, on the CPU: the class of that
    name in ``benchmark/reference/<config["reference"]>.py`` (this module
    by default), so that a new architecture's reference is a new file."""
    kwargs = config["kwargs"]
    module = importlib.import_module(
        "benchmark.reference." + config.get("reference", "models"))
    if module.__name__ == __name__:
        for key, allowed in FIXED.items():
            if key in kwargs and kwargs[key] not in allowed:
                raise ValueError(f"{key}={kwargs[key]!r} is not referenced")
    return getattr(module, config["class"])(**kwargs).eval()


def param_shapes(config):
    """{state_dict key: shape} of the configuration's network."""
    return {k: tuple(v.shape) for k, v in build(config).state_dict().items()}


class PadCrop:
    """EVREAL's CropParameters (utils/util.py): pad top ceil(d/2), bottom
    floor(d/2) (the same left and right) to a multiple of ``2 **
    num_encoders``; crop back around the padded image's centre."""

    def __init__(self, h, w, num_encoders):
        f = 2 ** num_encoders
        self.hp, self.wp = f * math.ceil(h / f), f * math.ceil(w / f)
        dh, dw = self.hp - h, self.wp - w
        self.pads = (math.ceil(dw / 2), dw // 2, math.ceil(dh / 2), dh // 2)
        cy, cx = self.hp // 2, self.wp // 2
        self.rows = slice(cy - h // 2, cy + math.ceil(h / 2))
        self.cols = slice(cx - w // 2, cx + math.ceil(w / 2))

    def pad(self, x):
        return F.pad(x, self.pads)

    def crop(self, x):
        return x[..., self.rows, self.cols]

"""SPADE-E2VID (``evreal_tpu/models/spade.py``; reference
model/spade_e2v.py, class Unet6), NCHW.

As in the reference:

* every BatchNorm runs on its running statistics (spade_e2v.py:12, 51);
* on the first frame the per-sample min/max-normalized first 3 bins
  replace them in the head's input and condition SPADE (the reference
  normalizes a view in place, spade_e2v.py:147-153);
* SPADE conditions on the previous 3-channel image through a nearest
  resize (spade_e2v.py:63-76);
* upsampling is PixelShuffle;
* the output is the channel mean of a 3-channel sigmoid(BN(conv)) image.

The state holds 4 ConvLSTM states (rec0..rec2, up2), ``prev_recs``
(N, 3, H, W) and a 0-d bool ``initialized``, which stays bool in every
serving dtype and is shared by the lanes of a lockstep batch (they start
together).
"""

import torch
import torch.nn.functional as F
from torch import nn

from evreal_tpu_torch.nn.cells import ConvLSTM, conv_lstm_zero_state
from evreal_tpu_torch.nn.layers import RunningNorm2d, resize_nearest

WIDTHS = (64, 128, 256)  # rec0..rec2 at full, half and quarter resolution
HEAD = 32                # the head and the full-resolution up2 ConvLSTM


class _RecConv(nn.Module):
    """spade_e2v.RecurrentConvLayer: conv (k5, no bias) -> BN -> relu ->
    ConvLSTM."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, cout, 5, stride=stride, padding=2,
                               bias=False)
        self.bn = RunningNorm2d(cout)
        self.recurrent_block = ConvLSTM(cout, cout, 3)

    def forward(self, x, state):
        return self.recurrent_block(torch.relu(self.bn(self.conv0(x))),
                                    state)


class _ResBlock(nn.Module):
    """spade_e2v.ResidualBlock: conv-BN-relu-conv-BN, skip, relu."""

    def __init__(self, ch):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.bn1 = RunningNorm2d(ch)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)
        self.bn2 = RunningNorm2d(ch)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + x)


class _Spade(nn.Module):
    """SPADE (spade_e2v.py:45-76): parameter-free BN of x, modulated by
    gamma and beta convs of the resized 3-channel conditioning image."""

    def __init__(self, norm_nc, hidden, label_nc=3):
        super().__init__()
        self.param_free_norm = RunningNorm2d(norm_nc, affine=False)
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, hidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(hidden, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(hidden, norm_nc, 3, padding=1)

    def forward(self, x, segmap):
        seg = resize_nearest(segmap, *x.shape[-2:])
        actv = self.mlp_shared(seg)
        return (self.param_free_norm(x) * (1 + self.mlp_gamma(actv))
                + self.mlp_beta(actv))


class _UpConv3(nn.Module):
    """UpConvLayer3 (spade_e2v.py:79-110): conv -> PixelShuffle(2) ->
    SPADE -> relu."""

    def __init__(self, cin, cout, hidden):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, 4 * cout, 3, padding=1)
        self.norm = _Spade(cout, hidden)

    def forward(self, x, x_org):
        return torch.relu(self.norm(F.pixel_shuffle(self.conv0(x), 2),
                                    x_org))


class SpadeE2vid(nn.Module):
    """Unet6 at its fixed widths; ``spade_hidden`` is SPADE's shared
    hidden width, which this repository does not record (read from a
    checkpoint by ``shape_kwargs``)."""

    def __init__(self, spade_hidden=128, **_):
        super().__init__()
        self.num_bins = 5
        self.num_encoders = 3  # forced by the harness (eval.py:132)
        c0, c1, c2 = WIDTHS
        self.fc = nn.Conv2d(self.num_bins, HEAD, 5, padding=2)
        self.rec0 = _RecConv(HEAD, c0, 1)
        self.rec1 = _RecConv(c0, c1, 2)
        self.rec2 = _RecConv(c1, c2, 2)
        self.res0 = _ResBlock(c2)
        self.res1 = _ResBlock(c2)
        self.up0 = _UpConv3(c2, c1, spade_hidden)
        self.up1 = _UpConv3(c1, c0, spade_hidden)
        self.up2 = _RecConv(c0, HEAD, 1)
        self.conv_img = nn.Conv2d(HEAD, 3, 1)
        self.bn_img = RunningNorm2d(3)

    @staticmethod
    def shape_kwargs(state_dict):
        return {"spade_hidden":
                int(state_dict["up0.norm.mlp_shared.0.weight"].shape[0])}

    def init_state(self, batch, h, w, device=None, dtype=torch.float32):
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2
        c0, c1, c2 = WIDTHS
        return {
            "rec0": conv_lstm_zero_state(batch, h, w, c0, device, dtype),
            "rec1": conv_lstm_zero_state(batch, h2, w2, c1, device, dtype),
            "rec2": conv_lstm_zero_state(batch, h4, w4, c2, device, dtype),
            "up2": conv_lstm_zero_state(batch, h, w, HEAD, device, dtype),
            "prev_recs": torch.zeros((batch, 3, h, w), device=device,
                                     dtype=dtype),
            "initialized": torch.zeros((), dtype=torch.bool, device=device),
        }

    def forward(self, voxel, state):
        # per-sample reduction: the lanes of a lockstep batch stay
        # independent (the reference always runs batch 1)
        first3 = voxel[:, :3]
        shifted = first3 - first3.amin(dim=(1, 2, 3), keepdim=True)
        mx = shifted.amax(dim=(1, 2, 3), keepdim=True)
        pos = mx > 0
        norm3 = torch.where(pos, shifted / torch.where(pos, mx,
                                                       torch.ones_like(mx)),
                            shifted)
        init = state["initialized"]
        x_org = torch.where(init, state["prev_recs"], norm3)
        head_in = torch.where(init, voxel,
                              torch.cat([norm3, voxel[:, 3:]], dim=1))

        head = torch.relu(self.fc(head_in))
        x0, s0 = self.rec0(head, state["rec0"])
        x1, s1 = self.rec1(x0, state["rec1"])
        x2, s2 = self.rec2(x1, state["rec2"])
        x = self.res1(self.res0(x2))
        x = self.up0(x + x2, x_org)
        x = self.up1(x + x1, x_org)
        x, s3 = self.up2(x + x0, state["up2"])
        img3 = torch.sigmoid(self.bn_img(self.conv_img(torch.relu(x + head))))
        new_state = {"rec0": s0, "rec1": s1, "rec2": s2, "up2": s3,
                     "prev_recs": img3,
                     "initialized": torch.ones_like(init)}
        return {"image": img3.mean(dim=1, keepdim=True)}, new_state

"""ET-Net (``evreal_tpu/models/etnet.py``; reference model/eitr/: EITR
wrapping mls_tpa, u_trans.py:12-123), NCHW.

CNN encoder (head, 3 recurrent stride-2 stages of 64/128/256 channels) ->
tokens of d = 256 at H/8 x W/8 from 3 scales (the H/8 map flattened; the
H/4 and H/2 maps patchified by stride-2 and stride-4 convs) -> per-scale
pre-LN transformer encoders, and decoders with cross-scale memory -> the
mean of the 6 streams -> 3 upsample decoders with sum skips -> 1x1 pred,
sigmoid. H and W must be divisible by 8 (num_encoders = 3 makes the
runner pad so).

The transformer's layer counts and FFN width, and the head's width, are
read from a checkpoint's arrays (``shape_kwargs``), as the JAX package
reads them implicitly; the defaults are the published 3 encoder and 2
decoder layers per scale, and an FFN width of 4 * d, which this
repository does not record.
"""

import torch
from torch import nn

from evreal_tpu_torch.nn.attention import (
    TransformerDecoder,
    TransformerEncoder,
    sinusoid_table,
)
from evreal_tpu_torch.nn.cells import RecurrentConvLayer, conv_lstm_zero_state
from evreal_tpu_torch.nn.layers import ConvLayer, UpsampleConvLayer
from evreal_tpu_torch.utils.spans import span

CHANNELS = (64, 128, 256)
D_MODEL, NUM_HEADS = 256, 8
# the spans of a step, each once a window step (inside the eval loop's
# ``evreal.step``)
ENCODE = "evreal.etnet.encode"            # head and ConvLSTM stages
TRANSFORMER = "evreal.etnet.transformer"  # tokens and the 6 streams
DECODE = "evreal.etnet.decode"            # upsample decoders, pred
SPANS = (ENCODE, TRANSFORMER, DECODE)


class EITR(nn.Module):
    """Its arguments are the eitr_kwargs (``build_model`` unwraps them)."""

    def __init__(self, num_bins=5, norm=None, base_num_channels=32,
                 num_encoder_layers=3, num_decoder_layers=2,
                 dim_feedforward=4 * D_MODEL, **_):
        super().__init__()
        self.num_bins = int(num_bins)
        self.norm = None if norm in (None, "none") else str(norm)
        self.num_encoders = 3  # forced by the harness (eval.py:152-153)
        base = int(base_num_channels)
        ins = (base,) + CHANNELS[:-1]
        self.head = ConvLayer(self.num_bins, base, 5, padding=2,
                              norm=self.norm)
        self.DownsampleConv = nn.ModuleList(
            RecurrentConvLayer(ins[i], CHANNELS[i], 5, stride=2, padding=2,
                               recurrent_block_type="convlstm",
                               norm=self.norm)
            for i in range(3))
        self.split1 = nn.Conv2d(CHANNELS[1], D_MODEL, 2, stride=2)
        self.split2 = nn.Conv2d(CHANNELS[0], D_MODEL, 4, stride=4)
        for i in range(3):
            self.add_module(f"trans_encoder{i}", TransformerEncoder(
                D_MODEL, NUM_HEADS, num_encoder_layers, dim_feedforward))
            self.add_module(f"trans_decoder{i}", TransformerDecoder(
                D_MODEL, NUM_HEADS, num_decoder_layers, dim_feedforward))
        self.UpsampleConv = nn.ModuleList(
            UpsampleConvLayer(CHANNELS[2 - i], ins[2 - i], 5, padding=2,
                              norm=self.norm)
            for i in range(3))
        self.pred = ConvLayer(base, 1, 1, activation=None, norm=self.norm)
        self._pos = {}

    @staticmethod
    def shape_kwargs(state_dict):
        def layers(prefix):
            return len({k[len(prefix):].split(".")[0] for k in state_dict
                        if k.startswith(prefix)})

        return {"base_num_channels":
                int(state_dict["head.conv2d.weight"].shape[0]),
                "num_encoder_layers": layers("trans_encoder0.encoder.layers."),
                "num_decoder_layers": layers("trans_decoder0.decoder.layers."),
                "dim_feedforward": int(state_dict[
                    "trans_encoder0.encoder.layers.0.linear1.weight"].shape[0])}

    def init_state(self, batch, h, w, device=None, dtype=torch.float32):
        states = []
        for c in CHANNELS:
            h, w = (h + 1) // 2, (w + 1) // 2
            states.append(conv_lstm_zero_state(batch, h, w, c, device,
                                               dtype))
        return states

    def encode_recurrent(self, voxel, state):
        """The recurrent prefix (head and the 3 ConvLSTM stages), the only
        part that carries state from frame to frame. Returns ((head, b0,
        b1, b2), new state)."""
        x = head = self.head(voxel)
        blocks, new_states = [], []
        for layer, st in zip(self.DownsampleConv, state):
            x, st = layer(x, st)
            blocks.append(x)
            new_states.append(st)
        return (head,) + tuple(blocks), new_states

    def pos_table(self, length, like):
        """The (1, L, d) sinusoid table in ``like``'s dtype and device
        (the JAX package adds it in f32; see ROADMAP.md, Queue 3)."""
        key = (length, like.dtype, like.device)
        if key not in self._pos:
            self._pos[key] = sinusoid_table(length, D_MODEL)[None].to(
                device=like.device, dtype=like.dtype)
        return self._pos[key]

    def decode_batched(self, feats):
        """The state-free suffix on any leading batch: tokens, the 6
        transformer streams (``TRANSFORMER``), the upsample decoders and
        pred (``DECODE``)."""
        head, b0, b1, b2 = feats
        n, _, h8, w8 = b2.shape
        with span(TRANSFORMER):
            pos = self.pos_table(h8 * w8, b2)

            def tokens(x):
                return x.flatten(2).transpose(1, 2)  # (N, L, d), row-major L

            hs0 = self.trans_encoder0(tokens(b2), pos)
            hs1 = self.trans_encoder1(tokens(self.split1(b1)), pos)
            hs2 = self.trans_encoder2(tokens(self.split2(b0)), pos)
            hc0 = self.trans_decoder0(hs0, hs0)
            hc1 = self.trans_decoder1(hs1, hs0)
            hc2 = self.trans_decoder2(hs2, hs1)
            hs = (hs0 + hs1 + hs2 + hc0 + hc1 + hc2) / 6
            x = hs.transpose(1, 2).reshape(n, D_MODEL, h8, w8)
        with span(DECODE):
            for layer, skip in zip(self.UpsampleConv, (b2, b1, b0)):
                x = layer(x + skip)
            return {"image": torch.sigmoid(self.pred(x + head))}

    def forward(self, voxel, state):
        with span(ENCODE):
            feats, new_states = self.encode_recurrent(voxel, state)
        return self.decode_batched(feats), new_states

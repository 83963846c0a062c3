"""ET-Net (Weng, Zhang and Xiong, Event-based Video Reconstruction Using
Transformer, ICCV 2021) in plain PyTorch, as EVREAL evaluates it
(``EITR`` over ``mls_tpa``, EVREAL model/eitr/u_trans.py), with EVREAL's
module paths so that a reference checkpoint's ``state_dict`` loads as it
is; eval mode, NCHW, float32:

* a 5x5 head (``base_num_channels``), three stride-2 5x5 encoders of 64,
  128 and 256 channels each followed by a 3x3 ConvLSTM;
* tokens of d = 256 at H/8 x W/8 from three scales: the H/8 map
  flattened, the H/4 map through a stride-2 2x2 convolution (``split1``),
  the H/2 map through a stride-4 4x4 one (``split2``);
* per scale a pre-LN transformer encoder of ``num_encoder_layers`` layers
  (the sine position table added once, before the first layer) and a
  pre-LN decoder of ``num_decoder_layers`` layers (self-attention, then
  cross-attention on the normed memory, then the FFN of width
  ``dim_feedforward``, ReLU): decoder 0 attends to encoder 0, decoder 1 to
  encoder 0, decoder 2 to encoder 1; 8 heads of 32;
* the mean of the six streams back on the H/8 grid, three upsample
  decoders (2x bilinear, half-pixel centres, 5x5 convolution, ReLU) with
  sum skips, a 1x1 prediction on the sum with the head, sigmoid.

``init_state`` and ``step`` have ``models.py``'s signatures, so
``lib/peaks.py:flops_per_window`` and ``pipeline.Recon`` take it as they
take the others; ``num_encoders`` is 3, which EVREAL's eval.py forces on
ET-Net.

Departures from EVREAL's u_trans.py, none of which changes the function:

* batch-first (N, L, E) tokens and attention written out (projection,
  matmul, scale, softmax, matmul) in place of ``nn.MultiheadAttention``'s
  sequence-first call, with its parameter names;
* the attention's products computed in blocks of queries
  (``QUERY_BLOCK_BYTES`` of scores at a time), so that a lockstep group's
  (lanes, 8, block, L) scores fit the card;
* the position table computed for the L tokens in float64 and rounded to
  float32, in place of a 20,000-row table sliced to L;
* the recurrent state starts at zeros (EVREAL's ConvLSTM starts from
  zeros when it has none);
* eval mode: no dropout.
"""

import math

import numpy as np
import torch
from torch import nn

from benchmark.reference.models import (ConvLayer, RecurrentConvLayer,
                                        UpsampleConvLayer)

CHANNELS = (64, 128, 256)
D_MODEL, NUM_HEADS = 256, 8
# scores (bytes) a block of queries may hold: 2 GiB
QUERY_BLOCK_BYTES = 2 ** 31


def sinusoid_table(n, d):
    """EVREAL's PositionalEncodingSine table (position_encoding.py):
    sin at even columns, cos at odd ones, of pos / 10000^(2 (j // 2) / d)."""
    pos = np.arange(n)[:, None]
    j = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d)
    table = np.where(j % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32))


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` in eval mode, batch-first, its products
    in blocks of queries."""

    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, query, key, value):
        n, lq, d = query.shape
        w, b = self.in_proj_weight, self.in_proj_bias

        def heads(x, i):
            y = nn.functional.linear(x, w[i * d:(i + 1) * d],
                                     b[i * d:(i + 1) * d])
            return y.view(n, -1, self.heads, d // self.heads).transpose(1, 2)

        q, k, v = heads(query, 0), heads(key, 1), heads(value, 2)
        lk = k.shape[2]
        block = max(1, QUERY_BLOCK_BYTES // (4 * n * self.heads * lk))
        out = torch.empty_like(q)
        scale = math.sqrt(d // self.heads)
        for i in range(0, lq, block):
            logits = torch.matmul(q[:, :, i:i + block],
                                  k.transpose(-1, -2)) / scale
            out[:, :, i:i + block] = torch.matmul(
                torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(n, lq, d))


class FFN(nn.Module):
    def __init__(self, d, ffn):
        super().__init__()
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)

    def ffn(self, x):
        return self.linear2(torch.relu(self.linear1(x)))


class EncoderLayer(FFN):
    """x + attn(LN(x)), then x + ffn(LN(x))."""

    def __init__(self, d, heads, ffn):
        super().__init__(d, ffn)
        self.self_attn = MultiheadAttention(d, heads)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x):
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y)
        return x + self.ffn(self.norm2(x))


class DecoderLayer(FFN):
    """x + self-attn(LN(x)), x + cross-attn(LN(x), LN(memory)), x +
    ffn(LN(x))."""

    def __init__(self, d, heads, ffn):
        super().__init__(d, ffn)
        self.self_attn = MultiheadAttention(d, heads)
        self.cross_attn = MultiheadAttention(d, heads)
        self.norm1 = nn.LayerNorm(d)
        self.norm21 = nn.LayerNorm(d)
        self.norm22 = nn.LayerNorm(d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, x, memory):
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y)
        mem = self.norm22(memory)
        x = x + self.cross_attn(self.norm21(x), mem, mem)
        return x + self.ffn(self.norm3(x))


class Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerEncoder(nn.Module):
    def __init__(self, d, heads, n, ffn):
        super().__init__()
        self.encoder = Layers(EncoderLayer(d, heads, ffn) for _ in range(n))

    def forward(self, x, pos):
        x = x + pos
        for layer in self.encoder.layers:
            x = layer(x)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, d, heads, n, ffn):
        super().__init__()
        self.decoder = Layers(DecoderLayer(d, heads, ffn) for _ in range(n))

    def forward(self, x, memory):
        for layer in self.decoder.layers:
            x = layer(x, memory)
        return x


class EITR(nn.Module):
    """EVREAL's ``EITR`` at its ``eitr_kwargs`` (``norm`` None), given
    nested as EVREAL's checkpoints hold them or as keywords."""

    def __init__(self, eitr_kwargs=None, **kwargs):
        super().__init__()
        kw = dict(eitr_kwargs if eitr_kwargs is not None else kwargs)
        num_bins, norm = kw.get("num_bins", 5), kw.get("norm")
        base_num_channels = kw.get("base_num_channels", 32)
        num_encoder_layers = kw.get("num_encoder_layers", 3)
        num_decoder_layers = kw.get("num_decoder_layers", 2)
        dim_feedforward = kw.get("dim_feedforward", 1024)
        if norm not in (None, "none"):
            raise ValueError(f"norm={norm!r} is not referenced")
        base = base_num_channels
        ins = (base,) + CHANNELS[:-1]
        self.head = ConvLayer(num_bins, base, 5, padding=2)
        self.DownsampleConv = nn.ModuleList(
            RecurrentConvLayer(ins[i], CHANNELS[i], 5) for i in range(3))
        self.split1 = nn.Conv2d(CHANNELS[1], D_MODEL, 2, stride=2)
        self.split2 = nn.Conv2d(CHANNELS[0], D_MODEL, 4, stride=4)
        for i in range(3):
            self.add_module(f"trans_encoder{i}", TransformerEncoder(
                D_MODEL, NUM_HEADS, num_encoder_layers, dim_feedforward))
            self.add_module(f"trans_decoder{i}", TransformerDecoder(
                D_MODEL, NUM_HEADS, num_decoder_layers, dim_feedforward))
        self.UpsampleConv = nn.ModuleList(
            UpsampleConvLayer(CHANNELS[2 - i], ins[2 - i], 5, 2)
            for i in range(3))
        self.pred = ConvLayer(base, 1, 1, relu=False)
        self.num_encoders = 3

    def init_state(self, n, h, w, device):
        states = []
        for c in CHANNELS:
            h, w = (h + 1) // 2, (w + 1) // 2
            z = torch.zeros((n, c, h, w), device=device)
            states.append((z, z))
        return states

    def step(self, x, state):
        x = head = self.head(x)
        blocks, new = [], []
        for enc, st in zip(self.DownsampleConv, state):
            x, st = enc(x, st)
            blocks.append(x)
            new.append(st)
        b0, b1, b2 = blocks
        n, _, h8, w8 = b2.shape
        pos = sinusoid_table(h8 * w8, D_MODEL).to(b2.device)

        def tokens(t):
            return t.flatten(2).transpose(1, 2)

        hs0 = self.trans_encoder0(tokens(b2), pos)
        hs1 = self.trans_encoder1(tokens(self.split1(b1)), pos)
        hs2 = self.trans_encoder2(tokens(self.split2(b0)), pos)
        hc0 = self.trans_decoder0(hs0, hs0)
        hc1 = self.trans_decoder1(hs1, hs0)
        hc2 = self.trans_decoder2(hs2, hs1)
        hs = (hs0 + hs1 + hs2 + hc0 + hc1 + hc2) / 6
        x = hs.transpose(1, 2).reshape(n, D_MODEL, h8, w8)
        for dec, skip in zip(self.UpsampleConv, (b2, b1, b0)):
            x = dec(x + skip)
        return torch.sigmoid(self.pred(x + head)), new

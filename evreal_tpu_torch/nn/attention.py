"""Multi-head attention and the transformer blocks of ET-Net
(``evreal_tpu/nn/attention.py``; reference model/eitr/
transformer_encoder.py:48-77, transformer_decoder.py:46-87, and the post-LN
variant of transformer.py, which no reference entry point reaches).

Parameters are named like torch's ``nn.MultiheadAttention``
(``in_proj_weight``, ``in_proj_bias``, ``out_proj``), so reference
checkpoints load directly. The projections are ``linear`` calls, which the
f32 parity mode (TF32 off) governs; the attention products go through
``kernels/attention_cuda.py:attention``: on the card the fused kernel, in
float32 whatever the stream's dtype (no (N, h, L, L) tensor in device
memory, every product an f32 FMA); on the CPU the written-out matmul and
softmax, in the stream's dtype. Layout is batch-first (N, L, E); eval
mode, no dropout.
"""

import numpy as np
import torch
from torch import nn

from evreal_tpu_torch.kernels.attention_cuda import attention, takes_kernel


class MultiheadAttention(nn.Module):
    """Eval-mode ``nn.MultiheadAttention`` (batch-first). The input
    projections pack by argument identity, as in the JAX package: one
    matmul against the whole ``in_proj_weight`` for self-attention, q and
    k together where they share an input (post-LN self-attention), k and v
    together where they share the memory (every cross-attention)."""

    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.num_heads = int(num_heads)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _project(self, x, lo, hi):
        """``x`` through rows ``lo:hi`` of the packed projection, split
        into (hi - lo) / E heads-shaped (N, L, h, d) tensors."""
        n, length, e = x.shape
        y = torch.nn.functional.linear(x, self.in_proj_weight[lo:hi],
                                       self.in_proj_bias[lo:hi])
        parts = (hi - lo) // e
        y = y.view(n, length, parts, self.num_heads, e // self.num_heads)
        return y.unbind(2)

    def forward(self, q_in, k_in, v_in):
        e = q_in.shape[-1]
        if q_in is k_in and k_in is v_in:
            q, k, v = self._project(q_in, 0, 3 * e)
        elif k_in is v_in:
            (q,) = self._project(q_in, 0, e)
            k, v = self._project(k_in, e, 3 * e)
        elif q_in is k_in:
            q, k = self._project(q_in, 0, 2 * e)
            (v,) = self._project(v_in, 2 * e, 3 * e)
        else:
            (q,) = self._project(q_in, 0, e)
            (k,) = self._project(k_in, e, 2 * e)
            (v,) = self._project(v_in, 2 * e, 3 * e)
        n, lq, _, _ = q.shape
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (N, h, L, d)
        if takes_kernel(q):
            # the kernel takes contiguous f32: a bf16 stream's products run
            # in f32 and round back to bf16
            q, k, v = (t.float().contiguous() for t in (q, k, v))
        out = attention(q, k, v).to(q_in.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(n, lq, e))


class _FeedForward(nn.Module):
    """``linear1`` -> relu -> ``linear2``, the layers' shared FFN."""

    def __init__(self, d_model, dim_feedforward):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def ffn(self, x):
        return self.linear2(torch.relu(self.linear1(x)))


class EncoderLayer(_FeedForward):
    """Pre-LN: x + attn(LN(x)), then x + ffn(LN(x))."""

    def __init__(self, d_model, num_heads, dim_feedforward):
        super().__init__(d_model, dim_feedforward)
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, src):
        q = self.norm1(src)
        src = src + self.self_attn(q, q, q)
        return src + self.ffn(self.norm2(src))


class DecoderLayer(_FeedForward):
    """Pre-LN: self-attention, cross-attention on the (normed) memory,
    FFN, each added to the stream."""

    def __init__(self, d_model, num_heads, dim_feedforward):
        super().__init__(d_model, dim_feedforward)
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.cross_attn = MultiheadAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm21 = nn.LayerNorm(d_model)
        self.norm22 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, tgt, memory):
        q = self.norm1(tgt)
        tgt = tgt + self.self_attn(q, q, q)
        q = self.norm21(tgt)
        kv = self.norm22(memory)
        tgt = tgt + self.cross_attn(q, kv, kv)
        return tgt + self.ffn(self.norm3(tgt))


class _Stack(nn.Module):
    """The ``layers`` list under its reference parent (``encoder`` or
    ``decoder``)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerEncoder(nn.Module):
    """Reference transformer_encoder: the position embedding is added once,
    before the first layer (transformer_encoder.py:36-45)."""

    def __init__(self, d_model, num_heads, num_layers, dim_feedforward):
        super().__init__()
        self.encoder = _Stack(EncoderLayer(d_model, num_heads,
                                           dim_feedforward)
                              for _ in range(num_layers))

    def forward(self, src, pos):
        out = src + pos
        for layer in self.encoder.layers:
            out = layer(out)
        return out


class TransformerDecoder(nn.Module):
    def __init__(self, d_model, num_heads, num_layers, dim_feedforward):
        super().__init__()
        self.decoder = _Stack(DecoderLayer(d_model, num_heads,
                                           dim_feedforward)
                              for _ in range(num_layers))

    def forward(self, tgt, memory):
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory)
        return tgt


# ---------------------------------------------------------------------------
# Post-LN encoder-decoder (reference model/eitr/transformer.py): LayerNorm
# after each residual add, and the position / task embedding re-added to q
# and k at every layer (transformer.py:82-86), not once before layer 0.


def _with_embed(x, embed):
    return x if embed is None else x + embed


class EncoderLayerPostLN(_FeedForward):
    """Reference TransformerEncoderLayer.forward (transformer.py:85-97)."""

    def __init__(self, d_model, num_heads, dim_feedforward):
        super().__init__(d_model, dim_feedforward)
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)

    def forward(self, src, pos):
        q = _with_embed(src, pos)
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.ffn(src))


class DecoderLayerPostLN(_FeedForward):
    """Reference TransformerDecoderLayer.forward (transformer.py:119-137)."""

    def __init__(self, d_model, num_heads, dim_feedforward):
        super().__init__(d_model, dim_feedforward)
        self.self_attn = MultiheadAttention(d_model, num_heads)
        self.cross_attn = MultiheadAttention(d_model, num_heads)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, tgt, memory, task_embed):
        q = _with_embed(tgt, task_embed)
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        q = _with_embed(tgt, task_embed)
        tgt = self.norm2(tgt + self.cross_attn(q, memory, memory))
        return self.norm3(tgt + self.ffn(tgt))


class TransformerPostLN(nn.Module):
    """Reference transformer.forward (transformer.py:30-34): the encoder's
    output feeds the decoder as both target and memory."""

    def __init__(self, d_model, num_heads, num_encoder_layers,
                 num_decoder_layers, dim_feedforward):
        super().__init__()
        self.encoder = _Stack(EncoderLayerPostLN(d_model, num_heads,
                                                 dim_feedforward)
                              for _ in range(num_encoder_layers))
        self.decoder = _Stack(DecoderLayerPostLN(d_model, num_heads,
                                                 dim_feedforward)
                              for _ in range(num_decoder_layers))

    def forward(self, src, pos, task_embed=None):
        out = src
        for layer in self.encoder.layers:
            out = layer(out, pos)
        tgt = memory = out
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, task_embed)
        return tgt


def sinusoid_table(n_position, d_hid):
    """Reference PositionalEncodingSine table (position_encoding.py:6-34),
    computed in float64 and returned as f32 ``(n_position, d_hid)``."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(table.astype(np.float32))

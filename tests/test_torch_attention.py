"""The port's attention blocks (evreal_tpu_torch/nn/attention.py) against
the JAX package's (evreal_tpu/nn/attention.py): multi-head attention in
each of its input-packing cases, the pre-LN encoder and decoder stacks of
ET-Net, and the post-LN encoder-decoder, with the port's weights taken
through the JAX package's converter; atol 2e-5 in f32. The sinusoid table
is bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evreal_tpu.convert.torch_ckpt import convert_state_dict, nest
from evreal_tpu.nn import attention as jatt
from evreal_tpu_torch.nn import attention as tatt

torch.set_num_threads(1)

ATOL = 2e-5
N, L, LK, E, HEADS, FFN = 2, 7, 5, 32, 4, 48


def params_of(module, seed):
    """Random weights (biases and LayerNorm affines too), and the JAX
    package's tree of them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            offset = 1.0 if ".norm" in name and name.endswith("weight") \
                else 0.0  # LayerNorm gains around 1
            p.copy_(torch.randn(p.shape, generator=g) * 0.2 + offset)
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    return nest(convert_state_dict(sd))


def inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def check(t_out, j_out):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("packing", ["qkv", "kv", "qk", "none"])
def test_multihead_attention_matches_jax(packing):
    mha = tatt.MultiheadAttention(E, HEADS)
    tree = params_of(mha, 1)
    q, k, v = inputs(2, (N, L, E), (N, LK, E), (N, LK, E))
    if packing == "qkv":
        args = (q, q, q)
    elif packing == "kv":
        args = (q, k, k)
    elif packing == "qk":
        args = (q, q, inputs(3, (N, L, E))[0])
    else:
        args = (q, k, v)
    # identical arguments stay identical objects on both sides
    t_args = {id(a): torch.from_numpy(a) for a in args}
    j_args = {id(a): jnp.asarray(a) for a in args}
    with torch.no_grad():
        got = mha(*(t_args[id(a)] for a in args))
    want = jatt.multihead_attention(tree, *(j_args[id(a)] for a in args),
                                    HEADS)
    check(got, want)


def test_pre_ln_encoder_and_decoder_match_jax():
    enc = tatt.TransformerEncoder(E, HEADS, 2, FFN)
    dec = tatt.TransformerDecoder(E, HEADS, 2, FFN)
    enc_tree, dec_tree = params_of(enc, 4), params_of(dec, 5)
    src, pos, mem = inputs(6, (N, L, E), (1, L, E), (N, L, E))
    with torch.no_grad():
        t_enc = enc(torch.from_numpy(src), torch.from_numpy(pos))
        t_dec = dec(t_enc, torch.from_numpy(mem))
    j_enc = jatt.transformer_encoder(enc_tree, jnp.asarray(src),
                                     jnp.asarray(pos), num_heads=HEADS)
    j_dec = jatt.transformer_decoder(dec_tree, j_enc, jnp.asarray(mem),
                                     num_heads=HEADS)
    check(t_enc, j_enc)
    check(t_dec, j_dec)


@pytest.mark.parametrize("with_task", [True, False])
def test_post_ln_transformer_matches_jax(with_task):
    tf = tatt.TransformerPostLN(E, HEADS, 2, 2, FFN)
    tree = params_of(tf, 7)
    src, pos, task = inputs(8, (N, L, E), (N, L, E), (N, L, E))
    task_t = torch.from_numpy(task) if with_task else None
    with torch.no_grad():
        got = tf(torch.from_numpy(src), torch.from_numpy(pos), task_t)
    want = jatt.transformer_postln(
        tree, jnp.asarray(src), jnp.asarray(pos),
        jnp.asarray(task) if with_task else None, num_heads=HEADS)
    check(got, want)


def test_sinusoid_table_is_bit_equal():
    got = tatt.sinusoid_table(690, 256)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jatt.sinusoid_table(690, 256)))

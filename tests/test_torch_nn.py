"""The port's layers and recurrent cells (evreal_tpu_torch/nn) against the
JAX package's functional forms, with the same numpy-made parameters (JAX
layout, bridged by from_jax_tree) and inputs; atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evreal_tpu.nn import cells as jc
from evreal_tpu.nn import layers as jl
from evreal_tpu_torch.convert.params import from_jax_tree
from evreal_tpu_torch.models import init
from evreal_tpu_torch.nn import cells as tc
from evreal_tpu_torch.nn import layers as tl

torch.set_num_threads(1)

ATOL = 1e-5


def nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def nchw(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


def loaded(module, tree):
    module.load_state_dict(from_jax_tree(tree), strict=True)
    return module.eval()


def norm_params(rng, c, affine=True):
    p = {"running_mean": rng.normal(size=c).astype(np.float32),
         "running_var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    if affine:
        p["weight"] = rng.normal(1.0, 0.1, c).astype(np.float32)
        p["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
    return p


def inputs(rng, n=2, c=4, h=13, w=18):
    return rng.normal(size=(n, c, h, w)).astype(np.float32)


@pytest.mark.parametrize("stride,activation,norm", [
    (1, "relu", None), (2, "relu", "BN"), (1, None, "IN"),
    (2, "tanh", None), (1, "sigmoid", "BN")])
def test_conv_layer(stride, activation, norm):
    rng = np.random.default_rng(0)
    tree = {"conv2d": init.conv(rng, 3, 3, 4, 6)}
    if norm:
        tree["norm_layer"] = norm_params(rng, 6, affine=norm == "BN")
    x = inputs(rng)
    mod = loaded(tl.ConvLayer(4, 6, 3, stride, 1, activation, norm), tree)
    want = jl.conv_layer(tree, nhwc(x), stride=stride, padding=1,
                         activation=activation, norm=norm)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, nchw(want), atol=ATOL)


@pytest.mark.parametrize("norm", [None, "BN", "IN"])
def test_upsample_conv_layer(norm):
    rng = np.random.default_rng(1)
    tree = {"conv2d": init.conv(rng, 5, 5, 4, 3)}
    if norm:
        tree["norm_layer"] = norm_params(rng, 3, affine=norm == "BN")
    x = inputs(rng, h=7, w=9)
    mod = loaded(tl.UpsampleConvLayer(4, 3, 5, padding=2, norm=norm), tree)
    want = jl.upsample_conv_layer(tree, nhwc(x), padding=2, norm=norm)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 14, 18)
    np.testing.assert_allclose(got, nchw(want), atol=ATOL)


def test_transposed_conv_layer():
    rng = np.random.default_rng(2)
    tree = {"transposed_conv2d": init.conv(rng, 5, 5, 4, 3)}
    x = inputs(rng, h=7, w=9)
    mod = loaded(tl.TransposedConvLayer(4, 3, 5, padding=2), tree)
    want = jl.transposed_conv_layer(tree, nhwc(x), padding=2)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 14, 18)
    np.testing.assert_allclose(got, nchw(want), atol=ATOL)


@pytest.mark.parametrize("norm", [None, "BN", "IN"])
def test_residual_block(norm):
    rng = np.random.default_rng(3)
    tree = init.resblock(rng, 4)
    if norm == "BN":
        tree["bn1"] = norm_params(rng, 4)
        tree["bn2"] = norm_params(rng, 4)
    x = inputs(rng)
    mod = loaded(tl.ResidualBlock(4, norm=norm), tree)
    want = jl.residual_block(tree, nhwc(x), norm=norm)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, nchw(want), atol=ATOL)


@pytest.mark.filterwarnings("ignore:Using padding='same' with even kernel")
@pytest.mark.parametrize("k", [3, 4])
def test_same_padding_even_kernel(k):
    """nn.Conv2d(padding='same') and the JAX conv2d 'same' rule agree: an
    even kernel pads the extra element on the bottom/right."""
    rng = np.random.default_rng(4)
    p = init.conv(rng, k, k, 4, 5)
    x = inputs(rng)
    conv = torch.nn.Conv2d(4, 5, k, padding="same")
    conv.load_state_dict(from_jax_tree(p))
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    want = jl.conv2d(p, nhwc(x), padding="same")
    np.testing.assert_allclose(got, nchw(want), atol=ATOL)


def test_activation_fn_names():
    assert tl.activation_fn("sigmoid") is torch.sigmoid
    assert tl.activation_fn("") is None and tl.activation_fn("none") is None
    assert tl.activation_fn("exp") is torch.exp
    with pytest.raises(ValueError, match="unknown activation"):
        tl.activation_fn("pi")


def rollout_pair(tmod, jfn, tree, xs, t_state, j_state):
    """Run both cells over xs (steps, N, C, H, W); compare every output."""
    for x in xs:
        with torch.no_grad():
            t_out, t_state = tmod(torch.from_numpy(x), t_state)
        j_out, j_state = jfn(tree, nhwc(x), j_state)
        np.testing.assert_allclose(t_out.numpy(), nchw(j_out), atol=ATOL)


def test_conv_lstm_gate_order():
    rng = np.random.default_rng(5)
    tree = init.lstm(rng, 3, 4, 6)
    xs = rng.normal(size=(3, 2, 4, 9, 11)).astype(np.float32)
    mod = loaded(tc.ConvLSTM(4, 6, 3), tree)
    rollout_pair(mod, jc.conv_lstm, tree, xs,
                 tc.conv_lstm_zero_state(2, 9, 11, 6),
                 jc.conv_lstm_zero_state(2, 9, 11, 6))


def test_conv_gru():
    rng = np.random.default_rng(6)
    tree = init.gru(rng, 3, 4, 6)
    for g in tree.values():  # nonzero biases exercise the gate split
        g["bias"] = rng.normal(size=6).astype(np.float32)
    xs = rng.normal(size=(3, 2, 4, 9, 11)).astype(np.float32)
    mod = loaded(tc.ConvGRU(4, 6, 3), tree)
    rollout_pair(mod, jc.conv_gru, tree, xs,
                 tc.conv_gru_zero_state(2, 9, 11, 6),
                 jc.conv_gru_zero_state(2, 9, 11, 6))


@pytest.mark.parametrize("cell", ["convlstm", "convgru"])
def test_recurrent_conv_layer(cell):
    rng = np.random.default_rng(7)
    make = init.lstm if cell == "convlstm" else init.gru
    tree = {"conv": {"conv2d": init.conv(rng, 5, 5, 4, 6)},
            "recurrent_block": make(rng, 3, 6, 6)}
    xs = rng.normal(size=(3, 1, 4, 14, 18)).astype(np.float32)
    mod = loaded(tc.RecurrentConvLayer(4, 6, 5, stride=2, padding=2,
                                       recurrent_block_type=cell), tree)
    zero_t = tc.zero_state_fn(cell)(1, 7, 9, 6)
    zero_j = (jc.conv_lstm_zero_state if cell == "convlstm"
              else jc.conv_gru_zero_state)(1, 7, 9, 6)

    def jfn(p, x, st):
        return jc.recurrent_conv_layer(p, x, st, stride=2, padding=2,
                                       recurrent_block_type=cell)
    rollout_pair(mod, jfn, tree, xs, zero_t, zero_j)


def test_recurrent_residual_layer():
    rng = np.random.default_rng(8)
    tree = {"conv": init.resblock(rng, 6),
            "recurrent_block": init.gru(rng, 3, 6, 6)}
    xs = rng.normal(size=(3, 1, 6, 9, 11)).astype(np.float32)
    mod = loaded(tc.RecurrentResidualLayer(6, "convgru"), tree)

    def jfn(p, x, st):
        return jc.recurrent_residual_layer(p, x, st,
                                           recurrent_block_type="convgru")
    rollout_pair(mod, jfn, tree, xs, tc.conv_gru_zero_state(1, 9, 11, 6),
                 jc.conv_gru_zero_state(1, 9, 11, 6))
